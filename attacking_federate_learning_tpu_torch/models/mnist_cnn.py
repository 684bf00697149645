"""MNIST CNN (LeNet-style): 2 conv + 2 fc, log-softmax head.

The JAX package's beyond-reference models/mnist_cnn.py (the reference
ships only the MLP for MNIST, data_sets.py:13-30), after the classic
torch MNIST example: conv1 1->10 k5, MaxPool(2); conv2 10->20 k5,
MaxPool(2); fc 320 -> 50 -> 10, every layer torch-default init.  Spatial
trace on 28x28 NCHW input: 28 -conv5-> 24 -pool2-> 12 -conv5-> 8 -pool2->
4.  Parameter order conv1.{weight,bias}, conv2.{weight,bias}, fc1, fc2 —
d = 21,840.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from attacking_federate_learning_tpu_torch.models.base import register
from attacking_federate_learning_tpu_torch.models.layers import (
    init_conv_, init_linear_
)


class MnistCNN(nn.Module):
    input_shape = (1, 28, 28)
    num_classes = 10

    def __init__(self, generator: torch.Generator):
        super().__init__()
        self.conv1 = init_conv_(nn.Conv2d(1, 10, 5), generator)
        self.conv2 = init_conv_(nn.Conv2d(10, 20, 5), generator)
        self.fc1 = init_linear_(nn.Linear(320, 50), generator)
        self.fc2 = init_linear_(nn.Linear(50, 10), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], 1, 28, 28)
        x = F.max_pool2d(F.relu(self.conv1(x)), 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 2)
        x = x.reshape(x.shape[0], -1)
        x = F.relu(self.fc1(x))
        return F.log_softmax(self.fc2(x), dim=-1)


@register("mnist_cnn")
def mnist_cnn(generator: torch.Generator) -> nn.Module:
    return MnistCNN(generator)
