"""WideResNet-40-4 for CIFAR-100, and the batch-statistics BatchNorm the
ResNets share.

Reproduces reference ``Cifar100Net`` (data_sets.py:108-149) as the JAX
package's models/wideresnet.py does: a pre-activation WideResNet with a
3x3 stem conv, three groups of (depth - 4) / 6 BasicBlocks
(data_sets.py:65-90) widening to [16k, 32k, 64k] channels with strides
[1, 2, 2], a final BN + ReLU, an 8x8 average pool and a linear head.
Init (data_sets.py:130-138): convs ~ N(0, sqrt(2 / (k k out))), BN
weight 1 and bias 0, fc bias 0 and torch-default fc weight.

BatchNorm normalizes with the statistics of the batch it is given, in
training and evaluation alike, and keeps no running buffers: the model
is a function of its trainable parameters alone and the wire vector is
exactly ``named_parameters()``.  The variance is the biased one (the
JAX package's ``jnp.var``; ``torch.var`` needs ``correction=0`` for
it).  Under ``torch.func.vmap`` over clients each client's statistics
come from its own B images; ``nn.BatchNorm2d`` is not used, since its
running statistics would be state outside the wire.

Parameters are registered in the JAX package's OrderedDict order
(conv1, block1..3 with blocks b0.. each bn1, conv1, bn2, conv2 and
convShortcut where the channel counts differ, bn1, fc), so the names of
``named_parameters()`` are the JAX parameter paths joined by dots.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from attacking_federate_learning_tpu_torch.models.base import register
from attacking_federate_learning_tpu_torch.models.layers import init_linear_
from attacking_federate_learning_tpu_torch.models.remat import remat_call

BN_EPS = 1e-5  # torch BatchNorm2d default


def batch_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """BN over (N, H, W) with the batch's own mean and biased variance
    (the JAX package's ``batch_norm``)."""
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), keepdim=True, correction=0)
    xn = (x - mean) * torch.rsqrt(var + BN_EPS)
    return xn * weight[None, :, None, None] + bias[None, :, None, None]


class BatchNorm(nn.Module):
    """Per-channel affine BatchNorm on batch statistics: weight 1, bias
    0, no buffers."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm(x, self.weight, self.bias)


def he_conv(in_ch: int, out_ch: int, ksize: int, generator: torch.Generator,
            stride: int = 1, padding: int = 0) -> nn.Conv2d:
    """A bias-free conv with the reference's N(0, sqrt(2 / (k k out)))
    weight (data_sets.py:130-133)."""
    conv = nn.Conv2d(in_ch, out_ch, ksize, stride=stride, padding=padding,
                     bias=False)
    with torch.no_grad():
        nn.init.normal_(conv.weight, 0.0,
                        math.sqrt(2.0 / (ksize * ksize * out_ch)),
                        generator=generator)
    return conv


class BasicBlock(nn.Module):
    """Pre-activation block (reference data_sets.py:81-90): where the
    channel counts differ the activated input feeds both branches and the
    shortcut is a strided 1x1 conv of it; otherwise the residual is the
    raw input."""

    def __init__(self, in_planes: int, out_planes: int, stride: int,
                 generator: torch.Generator):
        super().__init__()
        self.bn1 = BatchNorm(in_planes)
        self.conv1 = he_conv(in_planes, out_planes, 3, generator, stride, 1)
        self.bn2 = BatchNorm(out_planes)
        self.conv2 = he_conv(out_planes, out_planes, 3, generator, 1, 1)
        self.convShortcut = (he_conv(in_planes, out_planes, 1, generator,
                                     stride) if in_planes != out_planes
                             else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.convShortcut is None:
            branch = F.relu(self.bn1(x))
            residual = x
        else:
            x = F.relu(self.bn1(x))
            branch = x
            residual = self.convShortcut(x)
        out = F.relu(self.bn2(self.conv1(branch)))
        return residual + self.conv2(out)


class WideResNet(nn.Module):
    input_shape = (3, 32, 32)
    batch_stats = True   # evaluation runs one test batch at a time

    def __init__(self, generator: torch.Generator, depth: int = 40,
                 widen_factor: int = 4, num_classes: int = 100):
        super().__init__()
        if (depth - 4) % 6:
            raise ValueError(f"WideResNet depth must be 6 n + 4, got {depth}")
        n = (depth - 4) // 6
        ch = [16, 16 * widen_factor, 32 * widen_factor, 64 * widen_factor]
        strides = [1, 2, 2]
        self.num_classes = num_classes
        self.conv1 = he_conv(3, ch[0], 3, generator, 1, 1)
        for g in range(3):
            self.add_module(f"block{g + 1}", nn.ModuleDict(
                (f"b{b}", BasicBlock(ch[g] if b == 0 else ch[g + 1],
                                     ch[g + 1], strides[g] if b == 0 else 1,
                                     generator))
                for b in range(n)))
        self.bn1 = BatchNorm(ch[3])
        self.fc = init_linear_(nn.Linear(ch[3], num_classes), generator)
        with torch.no_grad():
            self.fc.bias.zero_()   # reference data_sets.py:137-138

    def forward(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """``remat`` recomputes each BasicBlock's activations in the
        backward (models/remat.py); the stem, final BN, pool and head keep
        theirs."""
        out = self.conv1(x.reshape(x.shape[0], 3, 32, 32))
        for g in range(3):
            for block in getattr(self, f"block{g + 1}").values():
                out = remat_call(block, out) if remat else block(out)
        out = F.avg_pool2d(F.relu(self.bn1(out)), 8)
        return F.log_softmax(self.fc(out.reshape(out.shape[0], -1)), dim=-1)


def make_wideresnet(depth: int = 40, widen_factor: int = 4,
                    num_classes: int = 100):
    """A model builder ``(generator) -> WideResNet`` of this shape."""
    def build(generator: torch.Generator) -> nn.Module:
        return WideResNet(generator, depth, widen_factor, num_classes)
    return build


register("wideresnet40_4")(make_wideresnet(40, 4, 100))
