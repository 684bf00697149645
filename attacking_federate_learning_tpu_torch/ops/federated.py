"""Federated primitives of the hierarchical round: placement, client map,
shard reduce.

The flat round materializes the whole (n, d) gradient matrix every round.
The hierarchical round streams the client axis instead, one megabatch of
m << n clients at a time (the JAX package's ``ops/federated.py``):

- :func:`make_placement` assigns the n clients (malicious = ids [0, f))
  to S = n / m megabatches on the host, malicious ids first in each
  megabatch; ``mal_placement`` says whether the colluders are dealt
  round-robin ('spread') or packed into the fewest megabatches
  ('concentrated').  Placement is part of the run's identity: no RNG.
- :func:`client_map` runs a per-megabatch function over the megabatches
  in megabatch order, a Python loop: only the megabatch the function is
  working on holds its (m, d) gradients.  The outputs stack along a
  leading shard axis.
- :func:`shard_reduce` is the tier-2 robust reduction over the (S, d)
  shard-estimate matrix (defenses/kernels.py ``shard_*`` entries), and
  :func:`two_tier_aggregate` both tiers over a matrix a caller already
  holds (tests and benchmarks; the engine never builds one).

The attack seam changes with the topology, as in the JAX package: an
attack crafts once per megabatch from that megabatch's malicious rows
only, so ALIE's envelope is per megabatch.

Over a device mesh whose clients axis holds more than one position
(parallel/mesh.py), :func:`client_map` is the JAX package's SPMD client
map: :func:`spmd_schedule` deals the megabatches out to the positions
(S must divide by the clients axis; a placement group whose megabatch
count does not divide is padded with duplicates of its first megabatch),
each position runs its own megabatch rows in order on its own replicas
(the arguments :func:`broadcast` gave it), the stacked outputs come to
the primary position in one tiled gather, and the schedule's ``select``
restores megabatch order and drops the padding.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from attacking_federate_learning_tpu_torch.parallel.mesh import PerPosition
from attacking_federate_learning_tpu_torch.utils.costs import stage_scope


class Placement(NamedTuple):
    """Host-side megabatch layout, a pure function of the config.

    ``grid[s]`` lists megabatch s's client ids, malicious ids first;
    ``mal_counts[s]`` is that count.  ``groups`` pairs each distinct
    malicious count with the megabatch ids that share it, the JAX
    package's scan groups: the sequential loop needs none; the SPMD map
    deals each group out to the positions (:func:`spmd_schedule`)."""

    grid: np.ndarray                       # (S, m) int32 client ids
    mal_counts: Tuple[int, ...]            # per-megabatch malicious rows
    groups: Tuple[Tuple[int, Tuple[int, ...]], ...]
    megabatch: int                         # m
    num_shards: int                        # S = n / m


def tier1_assumed(f: int, num_shards: int) -> int:
    """Default per-shard corrupted bound of the tier-1 estimator: the
    server does not know the placement, so it budgets for the evenly
    spread worst case, ceil(f / S)."""
    return -(-f // num_shards) if f > 0 else 0


def tier2_assumed(f: int, megabatch: int) -> int:
    """Default corrupted-shard bound of tier 2: the number of shards the
    f colluders could fill outright, ceil(f / m) (at least 1 whenever any
    colluder exists)."""
    return -(-f // megabatch) if f > 0 else 0


def make_placement(n: int, f: int, megabatch: int,
                   mal_placement: str = "spread") -> Placement:
    """Assign the n clients (malicious = ids [0, f)) to n/m megabatches:
    'spread' deals malicious ids round-robin (counts differ by at most
    one), 'concentrated' packs them into the fewest megabatches; honest
    ids fill the remaining slots in id order."""
    if megabatch < 1 or n % megabatch:
        raise ValueError(
            f"megabatch must divide users_count (n={n}, m={megabatch})")
    if mal_placement not in ("spread", "concentrated"):
        raise ValueError(f"mal_placement must be 'spread' or "
                         f"'concentrated', got {mal_placement!r}")
    m, S = megabatch, n // megabatch
    shards: list = [[] for _ in range(S)]
    for k in range(f):
        shards[k % S if mal_placement == "spread" else k // m].append(k)
    counts = tuple(len(s) for s in shards)
    honest = iter(range(f, n))
    for rows in shards:
        while len(rows) < m:
            rows.append(next(honest))
    grouped: dict = {}
    for sid, c in enumerate(counts):
        grouped.setdefault(c, []).append(sid)
    groups = tuple((c, tuple(sids)) for c, sids in grouped.items())
    return Placement(grid=np.asarray(shards, np.int32), mal_counts=counts,
                     groups=groups, megabatch=m, num_shards=S)


def stack_shards(outs):
    """Per-megabatch outputs (tensors, or tuples or dicts of them, nested)
    stacked along a new leading shard axis."""
    if isinstance(outs[0], tuple):
        return tuple(stack_shards(list(x)) for x in zip(*outs))
    if isinstance(outs[0], dict):
        return {k: stack_shards([o[k] for o in outs]) for k in outs[0]}
    return torch.stack(outs)


def _tree_map(fn, *trees):
    """``fn`` over the tensors of like-shaped nests of tuples and dicts."""
    if isinstance(trees[0], tuple):
        return tuple(_tree_map(fn, *xs) for xs in zip(*trees))
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _run_rows(shard_fn, heads, args, out):
    """``shard_fn(*head, *args)`` for each head in order.  ``out`` None:
    the results stacked; a tensor: each result stored in its row; a dict
    of buffers: those keys of each (dict) result stored in their rows,
    the other keys stacked, all in one dict.  A result is stored at
    once: one that views the megabatch's matrix (a Krum pick) must not
    keep it alive into the next megabatch."""
    rest = []
    for i, head in enumerate(heads):
        res = shard_fn(*head, *args)
        if out is None:
            rest.append(res)
        elif isinstance(out, dict):
            for k, buf in out.items():
                buf[i] = res[k]
            rest.append({k: v for k, v in res.items() if k not in out})
        else:
            out[i] = res
    if out is None:
        return stack_shards(rest)
    if isinstance(out, dict):
        return {**stack_shards(rest), **out}
    return out


class SpmdSchedule(NamedTuple):
    """Host-side SPMD plan of :func:`client_map` over the mesh clients
    axis, the JAX package's: one padded id grid per placement group
    (shape ``(k_g * parts, m)``; position q owns rows ``[q k_g, (q + 1)
    k_g)``), the groups' malicious counts, and ``select``: for each
    megabatch id, its row in the position-major gathered order (padded
    duplicate rows are never selected)."""

    grids: Tuple[np.ndarray, ...]      # per group: (k_g*parts, m) ids
    counts: Tuple[int, ...]            # per group malicious rows
    select: np.ndarray                 # (S,) gathered-row index per shard
    parts: int                         # mesh clients-axis size
    padded_shards: int                 # total scheduled rows (>= S)
    sids: Tuple[np.ndarray, ...] = ()  # per group: (k_g*parts,) shard ids


def spmd_schedule(placement: Placement, parts: int) -> SpmdSchedule:
    """Deal the placement's megabatches across the mesh clients axis
    (``parts`` positions), with the JAX package's rules and messages: S
    must divide by ``parts`` (anything else would silently replicate
    work); within a group a count that does not divide is padded with
    duplicates of the group's first megabatch (< parts extra rows per
    group), whose outputs ``select`` drops."""
    S = placement.num_shards
    if parts < 1:
        raise ValueError(f"mesh clients axis must be >= 1, got {parts}")
    if S % parts:
        raise ValueError(
            f"hierarchical SPMD tier-1 needs the megabatch count "
            f"S = users_count/megabatch divisible by the mesh clients "
            f"axis (S={S}, clients axis={parts}): pick --megabatch / "
            f"--mesh-shape so S % clients == 0 — silently replicating "
            f"megabatches across devices would defeat the sharding")
    grids, counts, per_dev, sid_rows = [], [], [], []
    for count, sids in placement.groups:
        k = -(-len(sids) // parts)
        padded = list(sids) + [sids[0]] * (k * parts - len(sids))
        grids.append(placement.grid[padded])
        counts.append(count)
        per_dev.append(k)
        sid_rows.append(np.asarray(padded, np.int32))
    k_sum = sum(per_dev)
    select = np.empty(S, np.int64)
    for gi, (_, sids) in enumerate(placement.groups):
        k, off = per_dev[gi], sum(per_dev[:gi])
        for r, sid in enumerate(sids):
            q, j = divmod(r, k)
            select[sid] = q * k_sum + off + j
    return SpmdSchedule(grids=tuple(grids), counts=tuple(counts),
                        select=select, parts=parts,
                        padded_shards=k_sum * parts,
                        sids=tuple(sid_rows))


def _local_buffers(out, rows: int, device):
    """A position's own (rows, ...) buffers shaped like ``out``'s."""
    if out is None:
        return None
    if isinstance(out, dict):
        return {k: _local_buffers(v, rows, device) for k, v in out.items()}
    return torch.empty((rows,) + tuple(out.shape[1:]), dtype=out.dtype,
                       device=device)


def _client_map_spmd(shard_fn, placement: Placement, plan, *args,
                     with_sid=False, out=None):
    """The SPMD client map: each position runs the group rows it owns
    (its slice of every group's padded grid, groups in order) with its
    own element of every :class:`PerPosition` argument, into its own
    buffers; then one tiled gather per output leaf brings the
    position-major stacks to the primary, and ``select`` restores
    megabatch order (and drops the padding), into ``out`` where given.
    The values are the sequential map's: the same function on the same
    rows."""
    sched = spmd_schedule(placement, plan.clients_parts)
    k_per = [g.shape[0] // sched.parts for g in sched.grids]
    local = []
    for q, dev in enumerate(plan.positions):
        heads = []
        for gi, count in enumerate(sched.counts):
            for j in range(q * k_per[gi], (q + 1) * k_per[gi]):
                ids = sched.grids[gi][j].astype(np.int64)
                heads.append((int(sched.sids[gi][j]), ids, count)
                             if with_sid else (ids, count))
        pargs = tuple(a[q] if isinstance(a, PerPosition) else a
                      for a in args)
        local.append(_run_rows(shard_fn, heads, pargs,
                               _local_buffers(out, len(heads), dev)))
    gathered = _tree_map(lambda *blocks: plan.all_gather(blocks), *local)
    sel = torch.from_numpy(sched.select)
    if plan.primary.type == "cuda":      # no host synchronisation
        sel = sel.pin_memory().to(plan.primary, non_blocking=True)
    if out is None:
        return _tree_map(lambda a: a[sel], gathered)
    if not isinstance(out, dict):
        return torch.index_select(gathered, 0, sel, out=out)
    res = {}
    for k, v in gathered.items():
        res[k] = (_tree_map(lambda a: a[sel], v) if k not in out
                  else torch.index_select(v, 0, sel, out=out[k]))
    return res


def broadcast(value, plan=None):
    """Server -> clients broadcast: the identity without a plan (every
    megabatch reads the one copy); over a mesh, a copy on every position
    (:meth:`MeshPlan.broadcast`)."""
    return value if plan is None else plan.broadcast(value)


def client_map(shard_fn, placement: Placement, *args, with_sid=False,
               out=None, plan=None):
    """Apply ``shard_fn(ids, mal_count, *args)`` to every megabatch, in
    megabatch order, and stack the results along a leading shard axis.

    ``ids`` is the megabatch's (m,) int64 host array of client ids
    (malicious first) and ``mal_count`` its malicious-row count.
    ``with_sid=True`` passes the shard id first, ``shard_fn(sid, ids,
    mal_count, *args)``, for the per-shard fault streams (keyed
    ``fold_in(fold_in(key, t), sid)``).  ``out``, an (S, ...) tensor,
    takes each result in place of stacking (a preallocated estimate
    matrix; ``shard_fn`` then returns one tensor), or a dict of such
    buffers takes those keys of ``shard_fn``'s dict results.

    ``plan``: a MeshPlan whose clients axis holds more than one position
    switches to the SPMD map (:func:`_client_map_spmd`), where each
    position reads its own element of the :class:`PerPosition` ``args``
    (:func:`broadcast`); None, or one position, is the sequential map."""
    if plan is not None and plan.clients_parts > 1:
        return _client_map_spmd(shard_fn, placement, plan, *args,
                                with_sid=with_sid, out=out)
    heads = []
    for sid in range(placement.num_shards):
        ids = placement.grid[sid].astype(np.int64)
        c = placement.mal_counts[sid]
        heads.append((sid, ids, c) if with_sid else (ids, c))
    return _run_rows(shard_fn, heads, args, out)


def shard_reduce(tier2_fn, estimates, num_shards: int,
                 corrupted_shards: int, alive_counts=None, **kw):
    """The tier-2 robust reduction over the (S, d) shard-estimate matrix:
    ``tier2_fn`` is a defenses/kernels.py ``shard_*`` entry;
    ``alive_counts`` (S,) carries each shard's effective cohort, a shard
    at 0 is excluded.  The ``tier2_aggregate`` stage (utils/costs.py),
    whatever ``tier2_fn`` the caller passes."""
    with stage_scope("tier2_aggregate"):
        return tier2_fn(estimates.float().contiguous(), num_shards,
                        corrupted_shards, alive_counts=alive_counts, **kw)


def two_tier_aggregate(users_grads, placement: Placement, tier1_fn,
                       tier2_fn, tier1_corrupted: int,
                       tier2_corrupted: int, mask=None, weights=None,
                       telemetry=False):
    """Both tiers over a MATERIALIZED (n, d) matrix (the engine never
    builds one; this is for the places that hold one: tests, where each
    tier-1 estimate must be bit for bit the flat defense on its shard's
    rows, and benchmarks).  ``mask`` (n,) is the quarantine seam: each
    megabatch's tier-1 runs mask-aware over its rows and tier 2 receives
    the per-shard alive counts; ``weights`` (n,) ride it (they need
    ``mask``).

    ``telemetry=True`` returns ``(agg, tier1_diag, tier2_diag)``: the flat
    defense's diagnostics on each shard's rows stacked along a leading
    shard axis (:func:`client_map`), and the tier-2 entry's (S,)-shaped
    record over the shard axis."""
    from attacking_federate_learning_tpu_torch.defenses.kernels import (
        check_weight_seam
    )

    check_weight_seam(mask, weights)
    m = placement.megabatch
    tkw = {"telemetry": True} if telemetry else {}

    dev = users_grads.device

    def shard_fn(ids, _c):
        idx = torch.from_numpy(ids).to(dev)
        rows = users_grads[idx].contiguous()
        kw = dict(tkw)
        if mask is not None:
            kw["mask"] = mask[idx].contiguous()
            if weights is not None:
                kw["weights"] = weights[idx].contiguous()
        est = tier1_fn(rows, m, tier1_corrupted, **kw)
        est, diag = est if telemetry else (est, None)
        out = {"est": est.float()}
        if mask is not None:
            out["alive"] = kw["mask"].sum().to(torch.int32)
        if telemetry:
            out["diag"] = diag
        return out

    out = client_map(shard_fn, placement)
    agg = shard_reduce(tier2_fn, out["est"], placement.num_shards,
                       tier2_corrupted, alive_counts=out.get("alive"),
                       **tkw)
    if not telemetry:
        return agg
    return agg[0], out["diag"], agg[1]


def auto_megabatch(n: int, cap: int = 512) -> Optional[int]:
    """The largest power-of-two megabatch <= cap that divides n with at
    least 2 shards (for callers that only know n)."""
    for m in (2 ** k for k in range(int(math.log2(max(cap, 1))), -1, -1)):
        if m <= cap and n % m == 0 and n // m >= 2:
            return m
    return None
