"""Blockwise pairwise distances over the clients axis of a mesh.

The JAX package's ``parallel/distances.py``: two explicit schedules for
the (n, n) distance matrix when the (n, d) gradient matrix is dealt out
over the positions of the clients axis (parallel/mesh.py), each position
holding its (n/p, d) block:

- ``allgather``: every position gathers the whole matrix once and
  computes its (n/p, n) rows of distances.  One collective, O(n d) a
  position.
- ``ring``: every position keeps only its own block and one visiting
  block; the visiting blocks rotate around the ring (``ppermute`` to the
  next position) while each position writes one (n/p, n/p) tile a step,
  at the visitor's column ``src * n/p``.  O(n d / p) a position, the
  schedule for client counts where a replicated matrix would not fit.

Each tile is :func:`~attacking_federate_learning_tpu_torch.ops.distances.
cross_sq_distances` (f32, bf16 widened), square-rooted; the row blocks
come back to the primary position in order, and the diagonal is zeroed
exactly, as in the JAX package (``D * (1 - eye)``).  The result is the
whole (n, n) matrix on the primary, within f32 rounding of the distance
kernel's (ops/distances.py).  These are plain PyTorch: the JAX package
computes them in XLA, not Pallas.  n must divide by the clients axis
(``shard_map``'s even blocks).

``mesh`` is a parallel/mesh.py ``Mesh`` or ``MeshPlan``; a plan laid over
the processes of a group (:func:`~.mesh.make_plan` inside one) runs the
same schedules across the process boundary: each process computes its
own positions' tiles, the ring's visiting blocks cross it by isend /
irecv, and the matrix gathers to the primary process (None elsewhere).
"""

from __future__ import annotations

import torch

from attacking_federate_learning_tpu_torch.ops.distances import (
    cross_sq_distances
)
from attacking_federate_learning_tpu_torch.parallel.mesh import MeshPlan


def _blocks(G: torch.Tensor, mesh):
    plan = mesh if isinstance(mesh, MeshPlan) else MeshPlan(mesh)
    p = plan.clients_parts
    if G.shape[0] % p:
        raise ValueError(
            f"blockwise distances need the rows divisible by the clients "
            f"mesh axis (n={G.shape[0]}, axis={p})")
    return plan, plan.split_rows(G)


def _zero_diagonal(D):
    if D is None:                      # another process of a group
        return None
    n = D.shape[0]
    return D * (1.0 - torch.eye(n, dtype=D.dtype, device=D.device))


def pairwise_distances_allgather(G: torch.Tensor, mesh) -> torch.Tensor:
    """(n, d) -> (n, n) f32 distances: every position gathers every block
    (one all-gather) and computes its (n/p, n) rows."""
    plan, blocks = _blocks(G, mesh)
    whole = plan.replicate_gather(blocks)
    tiles = [None if gb is None else torch.sqrt(cross_sq_distances(gb, gw))
             for gb, gw in zip(blocks, whole)]
    return _zero_diagonal(plan.all_gather(tiles))


def pairwise_distances_ring(G: torch.Tensor, mesh) -> torch.Tensor:
    """(n, d) -> (n, n) f32 distances by the ring schedule: p steps, each
    position computing one (n/p, n/p) tile a step against the block
    visiting it, the blocks passed on to the next position between
    steps (p - 1 rotations; the JAX program's p-th rotation is never
    read)."""
    plan, blocks = _blocks(G, mesh)
    p = plan.clients_parts
    n = G.shape[0]
    blk = n // p
    perm = [(i, (i + 1) % p) for i in range(p)]
    out = [torch.zeros((blk, n), dtype=torch.float32, device=dev)
           if plan.local(q) else None
           for q, dev in enumerate(plan.positions)]
    remote, src = blocks, list(range(p))
    for step in range(p):
        for q in range(p):
            if out[q] is None:
                continue
            s = src[q]
            out[q][:, s * blk:(s + 1) * blk] = torch.sqrt(
                cross_sq_distances(blocks[q], remote[q]))
        if step + 1 < p:
            remote = plan.ppermute(remote, perm)
            # After a shift a position holds its previous neighbour's.
            src = [(s + p - 1) % p for s in src]
    return _zero_diagonal(plan.all_gather(out))
