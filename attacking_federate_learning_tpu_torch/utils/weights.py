"""Carry model weights between the JAX package and the port, as numpy.

The JAX models keep their parameters as nested ordered mappings in
``.parameters()`` order, each leaf in torch's own layout (linear weights
(out, in), conv weights (O, I, kH, kW)), so the carry is a reshape and a
concatenation with no transpose.  The nesting is any depth: one level
for the MLP and the CNNs (``{'fc1': {'weight', 'bias'}, ...}``), four for
the ResNets (``{'stage1': {'b0': {'conv1': {'weight'}, ...}}}``).  The
port's parameter names are the same paths joined by dots
(``stage1.b0.conv1.weight``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Mapping

import numpy as np
import torch


def _leaves(tree: Mapping):
    for value in tree.values():
        if isinstance(value, Mapping):
            yield from _leaves(value)
        else:
            yield value


def from_jax_params(params_np: Mapping, device="cpu") -> torch.Tensor:
    """Nested numpy mapping -> flat f32 tensor in wire order (the leaves
    depth first, each mapping in its own order)."""
    parts = [np.asarray(leaf, np.float32).reshape(-1)
             for leaf in _leaves(params_np)]
    return torch.from_numpy(np.concatenate(parts)).to(device)


def to_jax_params(flat: torch.Tensor, module: torch.nn.Module) -> OrderedDict:
    """Flat (d,) tensor -> nested OrderedDict of numpy arrays, one level
    per dotted component of ``module``'s parameter names, shaped by its
    named parameters."""
    flat_np = flat.detach().to("cpu", torch.float32).numpy()
    out: OrderedDict = OrderedDict()
    off = 0
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, OrderedDict())
        size = p.numel()
        node[leaf] = flat_np[off:off + size].reshape(tuple(p.shape)).copy()
        off += size
    if off != flat_np.shape[0]:
        raise ValueError(f"flat vector has {flat_np.shape[0]} entries, "
                         f"the module {off}")
    return out
