"""Joining a multi-process run.

The JAX package's ``parallel/multihost.py`` joins ``jax.distributed``
from its environment, after which one mesh spans every host's devices.
The port's counterpart joins a ``torch.distributed`` process group from
the variables ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``), with ``nccl`` where every rank has a card of
its own and ``gloo`` otherwise (two ranks on one card: NCCL refuses a
card shared by two ranks, so they take gloo, and parallel/mesh.py stages
their CUDA tensors through pinned host memory).  On a single process it
does nothing, so one script runs anywhere:

    from attacking_federate_learning_tpu_torch.parallel import multihost
    multihost.initialize()            # env-driven; no-op locally
    plan = make_plan((world_size * positions, 1), devices=[...])

Inside a group :func:`~.mesh.make_plan` lays one mesh over every
process's positions (``devices`` are this process's; by default its
card, ``cuda:rank`` where there are enough, else ``cuda:0``), and the
flat round runs over it (core/engine.py); :func:`is_primary` names the
process that writes logs and checkpoints.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None) -> bool:
    """Join the process group; returns True if distributed mode is on.

    With no arguments, reads torchrun's variables: none of them set, or
    a world size of 1 with no address, is a single process and a no-op;
    some of them set but not all raises.  ``init_method`` (e.g.
    ``tcp://localhost:29500`` or ``file:///path``) takes the place of the
    address and port.  ``backend`` defaults to 'nccl' when every rank can
    have a card of its own (at least ``world_size`` visible), else
    'gloo'."""
    if torch.distributed.is_initialized():
        return True
    env = {k: os.environ.get(k) for k in _ENV}
    world_size = world_size if world_size is not None else _env_int(
        "WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    addr = env["MASTER_ADDR"] is not None or env["MASTER_PORT"] is not None
    if init_method is None and not addr and world_size in (None, 1):
        return False                    # a single process: nothing to join
    if init_method is None:
        missing = [k for k in _ENV if env[k] is None]
        if missing:
            raise ValueError(
                f"multihost.initialize: {', '.join(missing)} not set "
                f"(torchrun sets MASTER_ADDR, MASTER_PORT, WORLD_SIZE and "
                f"RANK together); set them all, or pass init_method, "
                f"world_size and rank")
        init_method = "env://"
    if world_size is None or rank is None:
        raise ValueError(
            "multihost.initialize: init_method needs world_size and rank")
    if backend is None:
        backend = ("nccl" if torch.cuda.is_available()
                   and torch.cuda.device_count() >= world_size else "gloo")
    torch.distributed.init_process_group(
        backend=backend, init_method=init_method, world_size=world_size,
        rank=rank)
    return True


def _env_int(name):
    v = os.environ.get(name)
    return int(v) if v is not None else None


def is_primary() -> bool:
    """True on the process that writes logs and checkpoints: rank 0, or
    the only process."""
    if not (torch.distributed.is_available()
            and torch.distributed.is_initialized()):
        return True
    return torch.distributed.get_rank() == 0
