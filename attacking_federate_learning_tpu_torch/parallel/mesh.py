"""The device mesh of the port: positions over the clients and model axes.

The JAX package lays a ``jax.sharding.Mesh`` with axes ('clients',
'model') over its devices, and one program (``shard_map``) runs one body
per device.  The port's counterpart is a (c, m) grid of *positions*:
position (i, j) is clients block i and model block j, each position owns
one ``torch.device`` and its own buffers, and the collectives are
explicit copies between positions:

- :meth:`MeshPlan.broadcast` copies a value to every clients-axis
  position (the JAX package's ``ops/federated.py:broadcast``);
- :meth:`MeshPlan.split_rows` deals the rows of a matrix out to the
  clients-axis positions, ``torch.tensor_split``'s blocks (uneven rows
  are legal, as GSPMD pads them);
- :meth:`MeshPlan.all_gather` is a tiled concatenation in position-major
  order, on the primary position (position (0, 0), where the server
  state lives) unless another device is named;
- :meth:`MeshPlan.ppermute` copies each position's block to the
  position a permutation names;
- over the model axis, :meth:`MeshPlan.split_cols` deals the columns of
  a matrix (or the coordinates of a vector) out to the model positions
  (0, j) and :meth:`MeshPlan.all_gather_cols` concatenates them back.
  The one sum over the model axis, that of the split Gram's partials,
  is made in position order inside ``ops/distances.py:gram_epilogue``.
  Each is a fixed sequence of copies and adds, so a run repeats bit for
  bit.

d is split over the model axis only where the axis divides it, as the
JAX package's ``_model_axis_or_none`` shards it (d = 79,510 splits at
m = 2 and is replicated at m = 4); where it does not, every model
position would hold the whole vector, and the work runs once, on the
primary (:meth:`MeshPlan.splits`).

With four cards the positions are ``cuda:0..3`` and the copies go
between cards; with one card a caller that wants four positions passes
``devices=[torch.device("cuda:0")] * 4``, and the same schedule runs with
same-device copies.  Each position holds its own buffers even where two
positions share a device (a clone), as ``device_put`` over a mesh does,
so a position can be told apart from the others.

Inside a ``torch.distributed`` group of more than one process
(parallel/multihost.py) :func:`make_plan` lays one mesh over every
process's positions: the global grid is each rank's local positions in
rank order, as JAX orders ``jax.devices()`` across processes.  A
process holds only its own positions' buffers (None stands for a
position of another process), and a collective that reaches another
process goes through ``torch.distributed``: all_gather, ``ppermute`` as
paired ``batch_isend_irecv``, the state broadcast from the primary, and
a gather to the primary.  Under ``gloo`` a CUDA tensor is staged through pinned
host memory.  Such a mesh has a clients axis only: a model axis across
processes is refused.
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
    position's device (None for a position of another process).  The
    SPMD client map hands a position its own element (ops/federated.py);
    the model axis' column blocks are one too."""

    __slots__ = ()


def _bounds(n: int, parts: int) -> list:
    cuts = [len(a) for a in np.array_split(np.arange(n), parts)]
    edges = np.concatenate([[0], np.cumsum(cuts)])
    return [(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:])]


class MeshPlan:
    """The placement and the collectives the engine uses over a mesh.
    The server state lives on the primary position (position (0, 0)),
    as column blocks on the model positions where the model axis splits
    d (:meth:`place_state`); the dataset is replicated to every
    clients-axis position; each round the weights are broadcast.

    ``group``, set by :func:`make_plan` inside a process group: this
    process's rank, the world size and each rank's count of positions."""

    def __init__(self, mesh: Mesh, group: Optional[dict] = None):
        self.mesh = mesh
        self.group = group
        if group is not None and mesh.shape[MODEL] != 1:
            raise ValueError(
                f"a mesh over {group['world']} processes has a clients "
                f"axis only: the model axis across processes (mesh_shape "
                f"(c, {mesh.shape[MODEL]})) is not supported; lay the "
                f"model axis inside one process")

    @property
    def clients_parts(self) -> int:
        """Clients-axis positions: > 1 switches the hierarchical round
        onto the SPMD client map (ops/federated.py)."""
        return self.mesh.shape[CLIENTS]

    @property
    def model_parts(self) -> int:
        """Model-axis positions."""
        return self.mesh.shape[MODEL]

    @property
    def positions(self) -> tuple:
        """The clients-axis positions' devices (model block 0), in
        position order."""
        return tuple(self.mesh.devices[:, 0])

    @property
    def model_positions(self) -> tuple:
        """The model-axis positions' devices (clients block 0): where the
        column blocks of the gradients and the server state live."""
        return tuple(self.mesh.devices[0, :])

    @property
    def primary(self) -> torch.device:
        return self.mesh.devices[0, 0]

    @property
    def home(self) -> torch.device:
        """Where this process keeps the server state: the primary, or in
        another process of a group its first position."""
        if self.group is None or self.group["rank"] == 0:
            return self.primary
        return self.positions[int(self.group["ends"][self.group["rank"]
                                                     - 1])]

    # --- processes -------------------------------------------------------
    @property
    def processes(self) -> int:
        return 1 if self.group is None else self.group["world"]

    @property
    def is_primary(self) -> bool:
        """This process holds the primary position."""
        return self.group is None or self.group["rank"] == 0

    def owner(self, q: int) -> int:
        """The rank whose process holds clients position q."""
        if self.group is None:
            return 0
        return int(np.searchsorted(self.group["ends"], q, side="right"))

    def local(self, q: int) -> bool:
        return self.group is None or self.owner(q) == self.group["rank"]

    # --- placement -------------------------------------------------------
    def broadcast(self, value):
        """``value`` copied to every clients-axis position, each copy its
        own buffer (None stays None).  In a group each process copies its
        own value to its own positions (None for another's): every
        process holds the same data, built from one seed, and the state
        the primary broadcast at the end of the last round
        (:meth:`broadcast_state`)."""
        if value is None:
            return None
        return PerPosition(value.to(dev, copy=True) if self.local(q)
                           else None
                           for q, dev in enumerate(self.positions))

    def splits(self, d: int) -> bool:
        """Whether d is split over the model axis: an axis wider than 1
        that divides it (JAX ``_model_axis_or_none``)."""
        return self.model_parts > 1 and d % self.model_parts == 0

    def place_state(self, state: ServerState) -> ServerState:
        """The server state as fresh f32 tensors: on the primary
        position, or, where the model axis splits d, as column blocks on
        the model positions (a :class:`PerPosition` each; JAX
        ``place_state``'s ``P(model)``).  The clients positions receive
        the whole weights by :meth:`broadcast` each round."""
        def place(a):
            a = torch.as_tensor(a)
            if isinstance(state.weights, PerPosition):
                return a
            if self.splits(a.shape[-1]):
                return self.split_cols(a.float())
            return a.to(self.home, torch.float32, copy=True)
        return ServerState(place(state.weights), place(state.velocity),
                           int(state.round))

    def broadcast_state(self, state: ServerState) -> ServerState:
        """The primary process's server state on every process of a group
        (weights, velocity and round counter broadcast), where each keeps
        it; the state as it is in one process."""
        if self.group is None:
            return state
        rnd = torch.tensor([int(state.round)], dtype=torch.int64,
                           device=state.weights.device)
        return ServerState(_dist_broadcast(state.weights),
                           _dist_broadcast(state.velocity),
                           int(_dist_broadcast(rnd)[0]))

    def whole_state(self, state: ServerState) -> ServerState:
        """``state`` with column blocks gathered into whole vectors on the
        primary; a whole state as it is."""
        if not isinstance(state.weights, PerPosition):
            return state
        return ServerState(self.all_gather_cols(state.weights),
                           self.all_gather_cols(state.velocity),
                           state.round)

    def place(self, shards, train_x, train_y, state: ServerState):
        """Initial placement: the client-to-sample matrix and the dataset
        replicated to every clients position (MNIST and CIFAR fit on a
        card), the server state by :meth:`place_state`."""
        return (self.broadcast(shards), self.broadcast(train_x),
                self.broadcast(train_y), self.place_state(state))

    def row_bounds(self, n: int) -> list:
        """``[(lo, hi), ...]``: the rows each clients position owns of an
        (n, ...) matrix, ``torch.tensor_split``'s blocks."""
        return _bounds(n, self.clients_parts)

    def col_bounds(self, d: int) -> list:
        """``[(lo, hi), ...]``: the columns each model position owns of a
        (..., d) matrix split over the model axis."""
        return _bounds(d, self.model_parts)

    def split_rows(self, x: torch.Tensor) -> PerPosition:
        """Each clients position's rows of ``x``, copied to it (the
        counterpart of the JAX package's ``constrain_grads``); None for
        a position of another process."""
        return PerPosition(
            blk.to(dev, copy=True) if self.local(q) else None
            for q, (blk, dev) in enumerate(zip(
                torch.tensor_split(x, self.clients_parts), self.positions)))

    def split_cols(self, x: torch.Tensor) -> PerPosition:
        """Each model position's columns of ``x`` (its last axis), copied
        to it contiguous: the column blocks of ``P(..., model)``."""
        return PerPosition(
            x[..., lo:hi].to(dev, copy=True).contiguous()
            for (lo, hi), dev in zip(self.col_bounds(x.shape[-1]),
                                     self.model_positions))

    # --- collectives -----------------------------------------------------
    def all_gather(self, blocks, device=None) -> Optional[torch.Tensor]:
        """The clients positions' blocks concatenated along rows in
        position order, on ``device`` (default: the primary).  Across
        processes the blocks gather to the primary process, and the
        others get None."""
        dev = self.home if device is None else torch.device(device)
        if self.group is None:
            return torch.cat([b.to(dev) for b in blocks])
        mine = [b for q, b in enumerate(blocks) if self.local(q)]
        return _dist_gather_rows(torch.cat(mine), dev, to_all=False)

    def replicate_gather(self, blocks) -> PerPosition:
        """The whole concatenation of the clients positions' blocks on
        every (local) clients position: one all-gather."""
        if self.group is None:
            whole = torch.cat([b.to(self.primary) for b in blocks])
        else:
            mine = [b for q, b in enumerate(blocks) if self.local(q)]
            whole = _dist_gather_rows(torch.cat(mine), self.home,
                                      to_all=True)
        return self.broadcast(whole)

    def all_gather_cols(self, blocks, device=None) -> torch.Tensor:
        """The model positions' column blocks concatenated along the last
        axis in position order, on ``device`` (default: the primary)."""
        dev = self.primary if device is None else torch.device(device)
        return torch.cat([b.to(dev) for b in blocks], dim=-1)

    def ppermute(self, blocks, perm) -> PerPosition:
        """``out[dst] = blocks[src]`` for each ``(src, dst)`` of ``perm``,
        copied to ``dst``'s device; a position nothing is sent to gets
        zeros (``lax.ppermute``'s rule).  Across processes a pair in two
        processes is an isend / irecv of one ``batch_isend_irecv``."""
        if self.group is None:
            out = [torch.zeros_like(b) for b in blocks]
            for src, dst in perm:
                out[dst] = blocks[src].to(self.positions[dst], copy=True)
            return PerPosition(out)
        like = next(b for b in blocks if b is not None)
        out = [torch.zeros_like(like, device=self.positions[q])
               if self.local(q) else None for q in range(len(blocks))]
        ops, recvs = [], []
        for src, dst in sorted(perm):
            if self.local(src) and self.local(dst):
                out[dst] = blocks[src].to(self.positions[dst], copy=True)
            elif self.local(src):
                ops.append(torch.distributed.P2POp(
                    torch.distributed.isend, _staged(blocks[src]),
                    self.owner(dst), tag=dst))
            elif self.local(dst):
                buf = _staged(torch.empty_like(out[dst]))
                ops.append(torch.distributed.P2POp(
                    torch.distributed.irecv, buf, self.owner(src),
                    tag=dst))
                recvs.append((dst, buf))
        if ops:
            for req in torch.distributed.batch_isend_irecv(ops):
                req.wait()
        for dst, buf in recvs:
            out[dst] = buf.to(self.positions[dst], copy=True)
        return PerPosition(out)


# --- torch.distributed transport --------------------------------------------

def _gloo() -> bool:
    return torch.distributed.get_backend() == "gloo"


def _staged(x: torch.Tensor) -> torch.Tensor:
    """``x`` where the backend can read it: a CUDA tensor through pinned
    host memory under gloo, anything else as it is (contiguous)."""
    if x.device.type == "cuda" and _gloo():
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        return host
    return x.contiguous()


def _dist_broadcast(value: torch.Tensor) -> torch.Tensor:
    """The primary process's ``value`` on every process (same shape and
    dtype everywhere), on ``value``'s device."""
    buf = _staged(value)
    torch.distributed.broadcast(buf, src=0)
    return buf.to(value.device)


def _dist_gather_rows(rows: torch.Tensor, device, to_all: bool):
    """Every process's ``rows`` concatenated in rank order: on every
    process (``to_all``), else on the primary process only (None on the
    others).  The row counts travel first, the blocks padded to the
    largest."""
    world = torch.distributed.get_world_size()
    counts = torch.tensor([rows.shape[0]], dtype=torch.int64)
    every = [torch.zeros_like(counts) for _ in range(world)]
    torch.distributed.all_gather(every, counts)
    counts = [int(c) for c in every]
    top = max(counts)
    pad = torch.zeros((top,) + tuple(rows.shape[1:]), dtype=rows.dtype,
                      device=rows.device)
    pad[:rows.shape[0]] = rows
    pad = _staged(pad)
    if to_all:
        parts = [torch.empty_like(pad) for _ in range(world)]
        torch.distributed.all_gather(parts, pad)
    else:
        primary = torch.distributed.get_rank() == 0
        parts = [torch.empty_like(pad) for _ in range(world)] if primary \
            else None
        torch.distributed.gather(pad, parts, dst=0)
        if not primary:
            return None
    return torch.cat([p[:c] for p, c in zip(parts, counts)]).to(device)


def _group_layout(devices: list) -> tuple:
    """(every rank's device list in rank order, this rank, each rank's
    end position in the global list) of a joined group."""
    world = torch.distributed.get_world_size()
    lists = [None] * world
    torch.distributed.all_gather_object(lists, [str(d) for d in devices])
    ends = np.cumsum([len(x) for x in lists])
    return ([torch.device(d) for x in lists for d in x],
            torch.distributed.get_rank(), ends)


def _in_group() -> bool:
    return (torch.distributed.is_available()
            and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1)


def make_plan(mesh_shape=None, devices=None) -> MeshPlan:
    """The plan of ``make_mesh(mesh_shape, devices)``.  Inside a
    ``torch.distributed`` group of more than one process, ``devices`` are
    this process's positions (default: its card, ``cuda:rank`` where
    every rank has one, else ``cuda:0``), and the mesh is laid over every
    process's positions in rank order; its shape counts them all."""
    if not _in_group():
        return MeshPlan(make_mesh(mesh_shape, devices))
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise ValueError("make_plan found no CUDA device in this "
                             "process of the group; pass devices=[...]")
        rank, world = (torch.distributed.get_rank(),
                       torch.distributed.get_world_size())
        devices = [torch.device("cuda", rank if count >= world else 0)]
    every, rank, ends = _group_layout(list(devices))
    if mesh_shape is not None and tuple(mesh_shape)[1] != 1:
        raise ValueError(
            f"a mesh over {len(ends)} processes has a clients axis only: "
            f"the model axis across processes (mesh_shape "
            f"{tuple(mesh_shape)}) is not supported; lay the model axis "
            f"inside one process")
    mesh = make_mesh(mesh_shape, every)
    return MeshPlan(mesh, group={"rank": rank, "world": len(ends),
                                 "ends": ends})
