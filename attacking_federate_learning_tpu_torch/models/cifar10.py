"""CIFAR-10 CNN: 2 conv + 3 fc, log-softmax head.

Reproduces reference ``Cifar10Net`` (data_sets.py:33-61) as the JAX
package's models/cifar10.py does: conv1 3->16 k3 (xavier weight,
data_sets.py:37), MaxPool(3); conv2 16->64 k4, MaxPool(4); fc 64 -> 384
-> 192 -> 10.  Spatial trace on 32x32 NCHW input: 32 -conv3-> 30 -pool3->
10 -conv4-> 7 -pool4-> 1 (floor mode).  Parameter order
conv1.{weight,bias}, conv2.{weight,bias}, fc1..fc3 — d = 117,706.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from attacking_federate_learning_tpu_torch.models.base import register
from attacking_federate_learning_tpu_torch.models.layers import (
    init_conv_, init_linear_
)


class Cifar10CNN(nn.Module):
    input_shape = (3, 32, 32)
    num_classes = 10

    def __init__(self, generator: torch.Generator):
        super().__init__()
        self.conv1 = init_conv_(nn.Conv2d(3, 16, 3), generator, xavier=True)
        self.conv2 = init_conv_(nn.Conv2d(16, 64, 4), generator)
        self.fc1 = init_linear_(nn.Linear(64, 384), generator)
        self.fc2 = init_linear_(nn.Linear(384, 192), generator)
        self.fc3 = init_linear_(nn.Linear(192, 10), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], 3, 32, 32)
        x = F.max_pool2d(F.relu(self.conv1(x)), 3)
        x = F.max_pool2d(F.relu(self.conv2(x)), 4)
        x = x.reshape(x.shape[0], -1)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return F.log_softmax(self.fc3(x), dim=-1)


@register("cifar10_cnn")
def cifar10_cnn(generator: torch.Generator) -> nn.Module:
    return Cifar10CNN(generator)
