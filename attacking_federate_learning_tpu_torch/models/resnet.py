"""ResNet-20 for CIFAR-10 (the JAX package's benchmark model, no reference
analog).

The JAX package's models/resnet.py: the He et al. CIFAR ResNet, a 3x3/16
stem, three stages of 3 post-activation basic blocks at [16, 32, 64]
channels with strides [1, 2, 2], a strided 1x1 conv projection where the
channels change, a global 8x8 average pool and a linear head; BatchNorm
on batch statistics (models/wideresnet.py).  Parameters in the JAX
order: conv1, bn1, stage1..3 (blocks b0..b2, each conv1, bn1, conv2,
bn2, then proj), fc — d = 272,282.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from attacking_federate_learning_tpu_torch.models.base import register
from attacking_federate_learning_tpu_torch.models.layers import init_linear_
from attacking_federate_learning_tpu_torch.models.remat import remat_call
from attacking_federate_learning_tpu_torch.models.wideresnet import (
    BatchNorm, he_conv
)


class Block(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int,
                 generator: torch.Generator):
        super().__init__()
        self.conv1 = he_conv(in_ch, out_ch, 3, generator, stride, 1)
        self.bn1 = BatchNorm(out_ch)
        self.conv2 = he_conv(out_ch, out_ch, 3, generator, 1, 1)
        self.bn2 = BatchNorm(out_ch)
        self.proj = (he_conv(in_ch, out_ch, 1, generator, stride)
                     if in_ch != out_ch else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.proj is not None:
            x = self.proj(x)
        return F.relu(x + out)


class ResNet20(nn.Module):
    input_shape = (3, 32, 32)
    batch_stats = True   # evaluation runs one test batch at a time

    def __init__(self, generator: torch.Generator, num_classes: int = 10):
        super().__init__()
        ch, strides = [16, 16, 32, 64], [1, 2, 2]
        self.num_classes = num_classes
        self.conv1 = he_conv(3, 16, 3, generator, 1, 1)
        self.bn1 = BatchNorm(16)
        for g in range(3):
            self.add_module(f"stage{g + 1}", nn.ModuleDict(
                (f"b{b}", Block(ch[g] if b == 0 else ch[g + 1], ch[g + 1],
                                strides[g] if b == 0 else 1, generator))
                for b in range(3)))
        self.fc = init_linear_(nn.Linear(ch[3], num_classes), generator)

    def forward(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """``remat`` recomputes each block's activations in the backward
        (models/remat.py); the stem, pool and head keep theirs."""
        out = F.relu(self.bn1(self.conv1(x.reshape(x.shape[0], 3, 32, 32))))
        for g in range(3):
            for block in getattr(self, f"stage{g + 1}").values():
                out = remat_call(block, out) if remat else block(out)
        out = F.avg_pool2d(out, 8)
        return F.log_softmax(self.fc(out.reshape(out.shape[0], -1)), dim=-1)


@register("resnet20")
def resnet20(generator: torch.Generator) -> nn.Module:
    return ResNet20(generator)
