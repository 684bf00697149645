"""Model registry: name -> builder of an ``nn.Module`` whose forward maps
(B, ...) inputs to (B, classes) log-probabilities.

Parameters are registered in the reference's ``.parameters()`` order, so
the flat wire vector (utils/flatten.py) matches the reference's byte
layout and the JAX package's.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

MODELS: Dict[str, Callable[..., nn.Module]] = {}


def register(name: str):
    def deco(builder):
        if name in MODELS:
            raise ValueError(f"model {name!r} registered twice")
        MODELS[name] = builder
        return builder
    return deco


def get_model(name: str, generator: torch.Generator) -> nn.Module:
    """Build model ``name`` on the CPU, initialized from ``generator``."""
    if name not in MODELS:
        raise ValueError(f"Unknown model {name!r}; have {sorted(MODELS)}")
    return MODELS[name](generator)
