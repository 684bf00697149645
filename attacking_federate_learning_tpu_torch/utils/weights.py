"""Carry model weights between the JAX package and the port, as numpy.

The JAX models keep each layer as an ordered mapping of ``weight``
(out, in) and ``bias`` — torch's own layout — in ``.parameters()`` order,
so the carry is a reshape and a concatenation with no transpose:
``{'fc1': {'weight', 'bias'}, 'fc2': {...}}`` <-> the flat (d,) wire
vector in the order fc1.weight, fc1.bias, fc2.weight, fc2.bias.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Mapping

import numpy as np
import torch


def from_jax_params(params_np: Mapping, device="cpu") -> torch.Tensor:
    """Nested {layer: {'weight', 'bias'}} numpy mapping -> flat f32 tensor
    in wire order (layers and their entries in mapping order)."""
    parts = []
    for layer in params_np.values():
        for name in ("weight", "bias"):
            if name in layer:
                parts.append(np.asarray(layer[name], np.float32).reshape(-1))
    return torch.from_numpy(np.concatenate(parts)).to(device)


def to_jax_params(flat: torch.Tensor, module: torch.nn.Module) -> OrderedDict:
    """Flat (d,) tensor -> OrderedDict {layer: OrderedDict(weight, bias)}
    of numpy arrays, shaped by ``module``'s named parameters."""
    flat_np = flat.detach().to("cpu", torch.float32).numpy()
    out: OrderedDict = OrderedDict()
    off = 0
    for name, p in module.named_parameters():
        layer, leaf = name.rsplit(".", 1)
        size = p.numel()
        out.setdefault(layer, OrderedDict())[leaf] = (
            flat_np[off:off + size].reshape(tuple(p.shape)).copy())
        off += size
    if off != flat_np.shape[0]:
        raise ValueError(f"flat vector has {flat_np.shape[0]} entries, "
                         f"the module {off}")
    return out
