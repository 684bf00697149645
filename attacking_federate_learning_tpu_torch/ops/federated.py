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

The SPMD client map over a device mesh (the JAX package's
``spmd_schedule`` and shard_map program) is the multi-GPU slice of the
port; here every megabatch runs on one device, in order.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from attacking_federate_learning_tpu_torch.utils.costs import stage_scope


class Placement(NamedTuple):
    """Host-side megabatch layout, a pure function of the config.

    ``grid[s]`` lists megabatch s's client ids, malicious ids first;
    ``mal_counts[s]`` is that count.  ``groups`` pairs each distinct
    malicious count with the megabatch ids that share it, the JAX
    package's scan groups (one static shape per group there; the port's
    loop needs none and keeps them for comparison)."""

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


def client_map(shard_fn, placement: Placement, *args, with_sid=False,
               out=None):
    """Apply ``shard_fn(ids, mal_count, *args)`` to every megabatch, in
    megabatch order, and stack the results along a leading shard axis.

    ``ids`` is the megabatch's (m,) int64 host array of client ids
    (malicious first) and ``mal_count`` its malicious-row count.
    ``with_sid=True`` passes the shard id first, ``shard_fn(sid, ids,
    mal_count, *args)``, for the per-shard fault streams (keyed
    ``fold_in(fold_in(key, t), sid)``).  ``out``, an (S, ...) tensor,
    takes each result in place of stacking (a preallocated estimate
    matrix); ``shard_fn`` must then return one tensor."""
    outs = []
    for sid in range(placement.num_shards):
        ids = placement.grid[sid].astype(np.int64)
        c = placement.mal_counts[sid]
        head = (sid, ids, c) if with_sid else (ids, c)
        # Stored at once: a result that views the megabatch's matrix (a
        # Krum pick) must not keep it alive into the next megabatch.
        if out is not None:
            out[sid] = shard_fn(*head, *args)
        else:
            outs.append(shard_fn(*head, *args))
    return out if out is not None else stack_shards(outs)


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
    dev = users_grads.device

    tkw = {"telemetry": True} if telemetry else {}

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
