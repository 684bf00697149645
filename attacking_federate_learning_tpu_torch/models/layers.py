"""Layer initializers and the loss, with the reference's init rules.

The reference xavier-initializes only fc1/conv1 weights (reference
data_sets.py:17, :37) and leaves everything else at torch defaults
(kaiming_uniform(a=sqrt(5)) for weights -> U(+-1/sqrt(fan_in)); bias the
same bound).  Every draw takes an explicit ``torch.Generator``, so an
initialization is a function of the seed alone.  Linear weights keep
torch's (out, in) layout and conv weights torch's (O, I, kH, kW), which
are also the JAX package's layouts (its models/layers.py).

The models' forward ops are torch's own, NCHW throughout: ``F.conv2d``
with padding 0 is the JAX package's VALID convolution, and
``F.max_pool2d(x, k)`` / ``F.avg_pool2d(x, k)`` default to stride k, no
padding and floor mode, its ``reduce_window`` with VALID padding.
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


def init_conv_(conv: nn.Conv2d, generator: torch.Generator,
               xavier: bool = False) -> nn.Conv2d:
    """The JAX package's ``conv_init``: xavier or torch-default uniform
    weight, fan_in = I kH kW and fan_out = O kH kW; the bias (if any)
    torch-default."""
    _, in_ch, kh, kw = conv.weight.shape
    fan_in = in_ch * kh * kw
    with torch.no_grad():
        if xavier:
            nn.init.xavier_uniform_(conv.weight, generator=generator)
        else:
            torch_default_uniform_(conv.weight, fan_in, generator)
        if conv.bias is not None:
            torch_default_uniform_(conv.bias, fan_in, generator)
    return conv


def nll_loss(log_probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """torch NLLLoss(mean) over log-probabilities (reference user.py:36,
    server.py:17)."""
    return -log_probs.gather(1, targets[:, None]).squeeze(1).mean()
