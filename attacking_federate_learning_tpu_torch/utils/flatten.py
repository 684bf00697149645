"""The wire format: model parameters <-> one flat vector.

The reference's load-bearing abstraction is a flat float vector of all
model parameters (``flatten_params`` reference user.py:17-18,
``row_into_parameters`` user.py:21-28): server state, the (n, d) gradient
matrix, defense inputs and attack perturbations all live in it.  The
order is the module's ``named_parameters()`` order, which for the
reference nets is fc1.weight, fc1.bias, fc2.weight, fc2.bias; the model
runs on a flat vector through ``torch.func.functional_call`` on views.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn


class FlatParams:
    """Bijection between a module's named parameters and the flat
    wire vector (shapes fixed at construction)."""

    def __init__(self, module: nn.Module):
        self.names: List[str] = []
        self.shapes: List[Tuple[int, ...]] = []
        for name, p in module.named_parameters():
            self.names.append(name)
            self.shapes.append(tuple(p.shape))
        self.numels = [int(torch.Size(s).numel()) for s in self.shapes]
        self.dim = sum(self.numels)

    def flatten(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Dict of named tensors -> (d,) vector in wire order."""
        return torch.cat([params[n].reshape(-1) for n in self.names])

    def unflatten(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(d,) vector -> dict of views in the module's shapes."""
        if flat.shape != (self.dim,):
            raise ValueError(f"flat vector must be ({self.dim},), "
                             f"got {tuple(flat.shape)}")
        out = {}
        for name, shape, chunk in zip(self.names, self.shapes,
                                      torch.split(flat, self.numels)):
            out[name] = chunk.view(shape)
        return out

    def module_vector(self, module: nn.Module) -> torch.Tensor:
        """The module's current parameters as a detached (d,) vector."""
        return self.flatten(
            {n: p.detach() for n, p in module.named_parameters()})
