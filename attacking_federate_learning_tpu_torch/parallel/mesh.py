"""The device mesh of the port: positions over the clients axis.

The JAX package lays a ``jax.sharding.Mesh`` with axes ('clients',
'model') over its devices, and one program (``shard_map``) runs one body
per device.  The port's counterpart is a mesh of *positions* in one
process: each position owns one ``torch.device`` and its own buffers,
and the collectives are explicit copies between positions:

- :meth:`MeshPlan.broadcast` copies a value to every position (the JAX
  package's ``ops/federated.py:broadcast``);
- :meth:`MeshPlan.split_rows` deals the rows of a matrix out to the
  positions, ``torch.tensor_split``'s blocks (uneven rows are legal, as
  GSPMD pads them);
- :meth:`MeshPlan.all_gather` is a tiled concatenation in position-major
  order, on the primary position (position 0, where the server state
  lives) unless another device is named;
- :meth:`MeshPlan.ppermute` copies each position's block to the
  position a permutation names.

With four cards the positions are ``cuda:0..3`` and the copies go
between cards; with one card a caller that wants four positions passes
``devices=[torch.device("cuda:0")] * 4``, and the same schedule runs with
same-device copies.  Each position holds its own buffers even where two
positions share a device (a clone), as ``device_put`` over a mesh does,
so a position can be told apart from the others.

Only the clients axis is ported: a mesh whose model axis is wider than 1
(the d-sharding of gradients and state) is refused, and so is a mesh
over the processes of a ``torch.distributed`` group.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from attacking_federate_learning_tpu_torch.core.server import ServerState

CLIENTS = "clients"
MODEL = "model"


class Mesh:
    """A (c, m) grid of positions, each a ``torch.device``; ``shape[axis]``
    is the axis' extent, as on a JAX mesh."""

    axis_names = (CLIENTS, MODEL)

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2:
            raise ValueError(f"a mesh is a (clients, model) grid of "
                             f"devices, got shape {devices.shape}")
        self.devices = devices
        self.shape = dict(zip(self.axis_names, devices.shape))


def make_mesh(mesh_shape: Optional[tuple] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Mesh over every visible CUDA device, or over ``devices``.

    ``mesh_shape=(c, m)`` splits the devices between the clients axis and
    the model axis; the default puts every device on the clients axis.  A
    device may appear more than once: each occurrence is a position of
    its own."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(
            torch.cuda.device_count() if torch.cuda.is_available() else 0)]
    devs = [torch.device(d) for d in devices]
    n = len(devs)
    if mesh_shape is None:
        if n == 0:
            raise ValueError(
                "make_mesh found no CUDA device; pass devices=[...] "
                "(e.g. [torch.device('cpu')] * 4) to lay a mesh of "
                "positions over the CPU")
        mesh_shape = (n, 1)
    c, m = mesh_shape
    if c * m != n:
        raise ValueError(f"mesh_shape {mesh_shape} != {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(c, m))


class PerPosition(tuple):
    """One value per position of a plan, each in its own buffer on its
    position's device.  The SPMD client map hands a position its own
    element (ops/federated.py); nothing else indexes across positions."""

    __slots__ = ()


def check_model_axis(mesh_shape) -> None:
    """Refuse a model axis wider than 1: not ported yet."""
    if mesh_shape is not None and tuple(mesh_shape)[1] != 1:
        raise ValueError(
            f"mesh_shape {tuple(mesh_shape)}: the model axis (d-sharding "
            f"of the gradients and the server state) is not ported yet; "
            f"the port runs the clients axis only, mesh_shape (c, 1)")


class MeshPlan:
    """The placement and the collectives the engine uses over a mesh's
    clients axis.  The server state lives on the primary position
    (position 0); the dataset is replicated to every position; each round
    the weights are broadcast."""

    def __init__(self, mesh: Mesh):
        check_model_axis((mesh.shape[CLIENTS], mesh.shape[MODEL]))
        self.mesh = mesh

    @property
    def clients_parts(self) -> int:
        """Clients-axis positions: > 1 switches the hierarchical round
        onto the SPMD client map (ops/federated.py)."""
        return self.mesh.shape[CLIENTS]

    @property
    def positions(self) -> tuple:
        """The clients-axis positions' devices, in position order."""
        return tuple(self.mesh.devices[:, 0])

    @property
    def primary(self) -> torch.device:
        return self.positions[0]

    # --- placement -----------------------------------------------------
    def broadcast(self, value):
        """``value`` copied to every position, each copy its own buffer
        (None stays None)."""
        if value is None:
            return None
        return PerPosition(value.to(dev, copy=True)
                           for dev in self.positions)

    def place_state(self, state: ServerState) -> ServerState:
        """The server state as fresh f32 tensors on the primary position;
        the positions receive the weights by :meth:`broadcast` each
        round."""
        def place(a):
            return torch.as_tensor(a).to(self.primary, torch.float32,
                                         copy=True)
        return ServerState(place(state.weights), place(state.velocity),
                           int(state.round))

    def place(self, shards, train_x, train_y, state: ServerState):
        """Initial placement: the client-to-sample matrix and the dataset
        replicated to every position (MNIST and CIFAR fit on a card), the
        server state on the primary."""
        return (self.broadcast(shards), self.broadcast(train_x),
                self.broadcast(train_y), self.place_state(state))

    def row_bounds(self, n: int) -> list:
        """``[(lo, hi), ...]``: the rows each position owns of an (n, ...)
        matrix, ``torch.tensor_split``'s blocks."""
        cuts = [len(a) for a in np.array_split(np.arange(n),
                                               self.clients_parts)]
        edges = np.concatenate([[0], np.cumsum(cuts)])
        return [(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:])]

    def split_rows(self, x: torch.Tensor) -> PerPosition:
        """Each position's rows of ``x``, copied to it (the counterpart
        of the JAX package's ``constrain_grads``)."""
        return PerPosition(
            blk.to(dev, copy=True) for blk, dev in zip(
                torch.tensor_split(x, self.clients_parts), self.positions))

    # --- collectives ---------------------------------------------------
    def all_gather(self, blocks, device=None) -> torch.Tensor:
        """The positions' blocks concatenated along rows in position
        order, on ``device`` (default: the primary)."""
        dev = self.primary if device is None else torch.device(device)
        return torch.cat([b.to(dev) for b in blocks])

    def ppermute(self, blocks, perm) -> PerPosition:
        """``out[dst] = blocks[src]`` for each ``(src, dst)`` of ``perm``,
        copied to ``dst``'s device; a position nothing is sent to gets
        zeros (``lax.ppermute``'s rule)."""
        out = [torch.zeros_like(b) for b in blocks]
        for src, dst in perm:
            out[dst] = blocks[src].to(self.positions[dst], copy=True)
        return PerPosition(out)


def make_plan(mesh_shape=None, devices=None) -> MeshPlan:
    """The plan of ``make_mesh(mesh_shape, devices)``.  A mesh is laid
    over this process's devices only: inside a ``torch.distributed``
    group of more than one process it is refused."""
    if (torch.distributed.is_available()
            and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1):
        raise ValueError(
            f"make_plan: this process is one of "
            f"{torch.distributed.get_world_size()} in a torch.distributed "
            f"group; a mesh over processes (multi-host) is not ported "
            f"yet — the port lays a mesh over one process's devices")
    check_model_axis(mesh_shape)
    return MeshPlan(make_mesh(mesh_shape, devices))
