"""MNIST MLP: 784 -> 100 -> 10, log-softmax head.

Reproduces reference ``MnistNet`` (data_sets.py:13-30): fc1 xavier-uniform
weight (data_sets.py:17), fc2 torch-default init, ReLU between, inputs
flattened to 784.  Parameter order fc1.weight, fc1.bias, fc2.weight,
fc2.bias — d = 79,510.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from attacking_federate_learning_tpu_torch.models.base import register
from attacking_federate_learning_tpu_torch.models.layers import init_linear_


class MnistMLP(nn.Module):
    input_shape = (784,)
    num_classes = 10

    def __init__(self, generator: torch.Generator):
        super().__init__()
        self.fc1 = init_linear_(nn.Linear(28 * 28, 100), generator,
                                xavier=True)
        self.fc2 = init_linear_(nn.Linear(100, 10), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Accepts (B, 784) or image-shaped input (reference
        # data.view(-1, 28*28), user.py:71).
        x = x.reshape(x.shape[0], -1)
        x = F.relu(self.fc1(x))
        return F.log_softmax(self.fc2(x), dim=-1)


@register("mnist_mlp")
def mnist_mlp(generator: torch.Generator) -> nn.Module:
    return MnistMLP(generator)
