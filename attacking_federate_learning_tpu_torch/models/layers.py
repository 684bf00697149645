"""Layer initializers and the loss, with the reference's init rules.

The reference xavier-initializes only fc1/conv1 weights (reference
data_sets.py:17, :37) and leaves everything else at torch defaults
(kaiming_uniform(a=sqrt(5)) for weights -> U(+-1/sqrt(fan_in)); bias the
same bound).  Every draw takes an explicit ``torch.Generator``, so an
initialization is a function of the seed alone.  Linear weights keep
torch's (out, in) layout, which is also the JAX package's layout.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def torch_default_uniform_(t: torch.Tensor, fan_in: int,
                           generator: torch.Generator) -> torch.Tensor:
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return nn.init.uniform_(t, -bound, bound, generator=generator)


def init_linear_(layer: nn.Linear, generator: torch.Generator,
                 xavier: bool = False) -> nn.Linear:
    with torch.no_grad():
        if xavier:
            nn.init.xavier_uniform_(layer.weight, generator=generator)
        else:
            torch_default_uniform_(layer.weight, layer.in_features,
                                   generator)
        torch_default_uniform_(layer.bias, layer.in_features, generator)
    return layer


def nll_loss(log_probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """torch NLLLoss(mean) over log-probabilities (reference user.py:36,
    server.py:17)."""
    return -log_probs.gather(1, targets[:, None]).squeeze(1).mean()
