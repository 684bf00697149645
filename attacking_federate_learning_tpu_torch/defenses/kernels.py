"""Robust-aggregation defenses over the (n, d) client-gradient matrix.

Each defense is ``(users_grads (n, d), users_count, corrupted_count) ->
aggregated (d,)`` — the reference registry's contract (reference
defences.py:73-75) — vectorized over the client axis:

- Krum's O(n^2 d) pairwise-distance dict (defences.py:16-21) becomes the
  fused distance -> score kernel (ops/defense_kernels.py:krum_scores) under
  a cancellation guard, or the distance kernel plus an exact sort.
- TrimmedMean's per-coordinate loop (defences.py:44-52) is the trimmed-mean
  kernel.
- Bulyan's destructive dict-popping selection (defences.py:55-70) is a
  fixed-trip loop over the distance kernel's matrix with an alive mask,
  then the trimmed-mean kernel over the selection.
- Median (defenses/median.py) is the median kernel.

Two seams reach every defense, as in the JAX package:

- ``mask`` (the quarantine seam, core/faults.py): an (n,) bool
  effective-cohort mask.  Each defense then computes its estimator over
  the alive rows only, with fixed shapes: NoDefense the alive mean, Krum
  exact sort scoring over the distance kernel with dead rows and columns
  at +inf (never the fused score kernel, whose complement identity
  assumes the static pool), TrimmedMean and Bulyan's tail the masked
  trimmed-mean kernel, Bulyan a selection loop over the alive pool.
- ``weights`` (the staleness seam of async rounds; requires ``mask``):
  per-row weights for the means.  Selections stay unweighted.

On a CUDA tensor every kernel call launches the CUDA kernel; on a CPU
tensor the same calls take the kernels' plain PyTorch versions.  The
selection loop and the sort fallback are plain tensor code on both, as
they are plain XLA in the JAX package.

The wire may be bf16 (``grad_dtype``), and ``distance_dtype`` may ask for
bf16 distances; the routes are those of the JAX package's Pallas suite,
asymmetry included: unmasked Krum hands the wire to the fused score
kernel as it is (a bf16 wire takes its bf16 route even at
``distance_dtype=None``), while every distance matrix (the guard's
fallback, masked Krum, Bulyan) casts the wire to ``distance_dtype``, f32
when it is None (:func:`distances_for`).  The coordinate-wise kernels
widen a bf16 matrix to f32; NoDefense's mean of a bf16 wire sums in f32
and rounds to bf16 once, as ``jnp.mean`` does.

Semantics match the reference's exact variants, quirks included: Krum
scores sum the (users_count - corrupted_count) *smallest* distances, not
the paper's n-f-2 (defences.py:26, 33-34; ``paper_scoring`` switches);
TrimmedMean keeps the n-f-1 values closest to the median (defences.py:45,
:50-51); Bulyan's inner Krum runs with the pool shrinking while f stays
fixed (defences.py:62), and its final trim keeps set_size - 2f - 1.  Ties
resolve to the lowest index (``torch.argmin`` returns the first minimum),
matching ``current_error < minimal_error`` (defences.py:35).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from attacking_federate_learning_tpu_torch.ops.defense_kernels import (
    krum_complement, krum_scores, masked_trimmed_mean, trimmed_mean_of
)
from attacking_federate_learning_tpu_torch.ops.distances import (
    pairwise_distances
)

# topk cancellation guard: required ratio of a row's kept score mass to
# the complement subtraction's noise floor (eps * log2(n) * rowsum).
# 1e4 keeps the relative score error under ~1e-4 whenever the complement
# identity is used; below that the scores come from the exact sort.
_TOPK_GUARD = 1e4

# Bulyan's masked selection: a dead, unselected row competes at this
# finite score, below +inf (already selected) and above any real score.
_DEAD_SENTINEL = 3e38

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def distances_for(users_grads, distance_dtype: Optional[str] = None):
    """The Krum/Bulyan distance matrix from the distance kernel, as the
    JAX package's ``_distances_for(..., 'pallas', distance_dtype)``: the
    matrix cast to ``distance_dtype`` ('bfloat16': the kernel's bf16
    route), or to f32 when it is None, whatever the wire's dtype."""
    dtype = _DTYPES[distance_dtype or "float32"]
    return pairwise_distances(users_grads.to(dtype).contiguous())


def check_weight_seam(mask, weights):
    """The staleness weights ride the quarantine mask: weights without a
    mask have no delivered cohort to weight and are a caller bug."""
    if weights is not None and mask is None:
        raise ValueError(
            "defense weights= requires mask= (staleness weights apply "
            "to the delivered cohort only; core/async_rounds.py)")


def no_defense(users_grads, users_count, corrupted_count, mask=None,
               weights=None):
    """Plain FedAvg mean (reference defences.py:13-14); with ``mask`` the
    mean of the alive rows (a zeroed dropout row must not drag it toward
    zero), with ``weights`` the weighted alive mean sum(w g) / sum(w)."""
    check_weight_seam(mask, weights)
    if weights is not None:
        w = torch.where(mask, weights, 0.0)
        return (w @ users_grads.float()) / torch.clamp(w.sum(), min=1e-12)
    # The sums run in f32 and round to the wire's dtype once (jnp.mean
    # and jnp.sum of a bf16 matrix).
    dtype = users_grads.dtype
    if mask is None:
        return users_grads.mean(0, dtype=torch.float32).to(dtype)
    e = torch.clamp(mask.sum(), min=1)
    return torch.where(mask[:, None], users_grads, 0.0).sum(
        0, dtype=torch.float32).to(dtype) / e


def sort_scores(D, users_count, corrupted_count, paper_scoring=False,
                alive=None):
    """Exact Krum scores from a zero-diagonal distance matrix: sort each
    row (self-distance at +inf, so it never counts) and sum the k =
    users_count - corrupted_count (- 2 paper) smallest entries.  With an
    ``alive`` mask, dead rows and columns go to +inf, ``users_count`` is
    the alive count, and a dead row's score is +inf."""
    n = D.shape[0]
    Dm = D + torch.diag(torch.full((n,), torch.inf, device=D.device))
    if alive is not None:
        row_dead = torch.where(alive, 0.0, torch.inf)
        Dm = Dm + row_dead[None, :] + row_dead[:, None]
    k = users_count - corrupted_count - (2 if paper_scoring else 0)
    srt = torch.sort(Dm, dim=1).values
    prefix = (torch.arange(n, device=D.device) < k)[None, :] & torch.isfinite(
        srt)
    scores = torch.where(prefix, srt, 0.0).sum(1)
    if alive is not None:
        scores = torch.where(alive, scores, torch.inf)
    return scores


def guarded_krum_scores(users_grads, users_count, corrupted_count,
                        paper_scoring=False, distance_dtype=None):
    """The fused kernel's scores under the cancellation guard of the JAX
    package's ``_pallas_krum_scores_guarded``: the fused evaluation is the
    complement identity (rowsum minus the c largest), so whenever a row's
    kept mass falls below the subtraction's noise floor, or a rowsum is
    not finite, the scores are re-evaluated exactly by sorting the
    distance matrix.  c == 0 is the pure rowsum: no subtraction, no
    guard.  c < 0 (f = 0 without paper scoring) has no complement to
    drop: the scores come from the exact sort, as the JAX package's
    ``_krum_scores`` takes them.  The guard's decision is one
    device-to-host read.

    The fused kernel takes the matrix as it is, or cast to
    ``distance_dtype``: a bf16 wire takes its bf16 route.  The sort's
    distance matrix is :func:`distances_for`'s."""
    if corrupted_count - 1 + (2 if paper_scoring else 0) < 0:
        return sort_scores(distances_for(users_grads, distance_dtype),
                           users_count, corrupted_count, paper_scoring)
    op = users_grads
    if distance_dtype is not None:
        op = op.to(_DTYPES[distance_dtype]).contiguous()
    scores, rowsum = krum_scores(op, corrupted_count, paper_scoring)
    n = users_grads.shape[0]
    if krum_complement(n, corrupted_count, paper_scoring) == 0:
        return scores
    eps = torch.finfo(torch.float32).eps
    floor = _TOPK_GUARD * eps * max(math.log2(max(n, 2)), 1.0) * rowsum
    reliable = bool(((scores >= floor) & torch.isfinite(rowsum)).all())
    if reliable:
        return scores
    return sort_scores(distances_for(users_grads, distance_dtype),
                       users_count, corrupted_count, paper_scoring)


def krum_select(users_grads, users_count, corrupted_count,
                paper_scoring=False, method="sort", mask=None,
                distance_dtype=None):
    """Index (0-d tensor) of the Krum winner (reference ``krum(...,
    return_index=True)``, defences.py:39-40).  ``method='sort'`` scores
    the distance kernel's matrix exactly by sort; ``'fused'`` uses the
    fused score kernel under its guard (what the engine runs, as the JAX
    package's Pallas route does).  With ``mask`` both score exactly by
    sort over the distance kernel, with k following the alive count e -
    f, and a dead row never wins.  ``distance_dtype`` as for
    :func:`distances_for` and :func:`guarded_krum_scores`."""
    if method not in ("sort", "fused"):
        raise ValueError(f"method must be 'sort' or 'fused', got {method!r}")
    if mask is not None:
        scores = sort_scores(distances_for(users_grads, distance_dtype),
                             mask.sum(), corrupted_count, paper_scoring,
                             alive=mask)
    elif method == "fused":
        scores = guarded_krum_scores(users_grads, users_count,
                                     corrupted_count, paper_scoring,
                                     distance_dtype)
    else:
        scores = sort_scores(distances_for(users_grads, distance_dtype),
                             users_count, corrupted_count, paper_scoring)
    return torch.argmin(scores)


def krum(users_grads, users_count, corrupted_count, paper_scoring=False,
         method="sort", mask=None, weights=None, distance_dtype=None):
    """Krum (reference defences.py:23-42): the single gradient whose summed
    distance to its k nearest peers is minimal; with ``mask`` the Krum
    choice of the alive rows, with ``weights`` scaled by its weight."""
    check_weight_seam(mask, weights)
    idx = krum_select(users_grads, users_count, corrupted_count,
                      paper_scoring=paper_scoring, method=method, mask=mask,
                      distance_dtype=distance_dtype)
    if weights is not None:
        return users_grads[idx] * weights[idx]
    return users_grads[idx]


def trimmed_mean(users_grads, users_count, corrupted_count, mask=None,
                 weights=None):
    """Reference defences.py:44-52; keeps n - f - 1 coordinates.  With
    ``mask`` the estimator of the alive rows, keeping e - f - 1 (at least
    1) of the e alive values, the mean weighted by ``weights`` if given."""
    check_weight_seam(mask, weights)
    if mask is not None:
        return masked_trimmed_mean(users_grads, mask, corrupted_count + 1,
                                   weights)
    return trimmed_mean_of(users_grads,
                           users_grads.shape[0] - corrupted_count - 1)


def bulyan_select(D, users_count, corrupted_count, paper_scoring=False,
                  mask=None, batch_select=1):
    """Bulyan's selection (reference defences.py:55-68) over a zero-diagonal
    distance matrix: set_size = n - 2f rounds of Krum, each removing its
    winner from the pool, with the pool size (but not f) shrinking.

    ``batch_select`` q > 1 (the JAX package's flagged relaxation): each
    trip takes the q lowest scores at once, ceil(set_size / q) trips, the
    last taking what is left; k follows the pool at the trip's start.
    Equal scores go lowest index first, as ``lax.top_k`` orders them (a
    stable sort: ``torch.topk`` promises no order of ties).

    Each row is sorted once; a round's score is the pool-masked prefix sum
    of its k smallest entries over the presorted row — the same multiset
    of k smallest as a re-sort, so the same scores.  Returns the (set_size,)
    int64 selected indices in selection order, on D's device, with no
    host synchronization.

    With ``mask`` the pool is the alive unselected rows and k = max(pool
    - f (- 2), 1).  Three levels decide a round: alive unselected rows
    compete on their scores, dead unselected rows on a finite sentinel
    (picked, lowest index first, only once the alive pool is empty), and
    selected rows sit at +inf.  The selection keeps its static size."""
    n = D.shape[0]
    f = corrupted_count
    p = 2 if paper_scoring else 0
    set_size = users_count - 2 * f
    q = int(batch_select)
    if q < 1:
        raise ValueError(f"batch_select must be >= 1, got {batch_select}")
    q = min(q, set_size)
    Dm = D + torch.diag(torch.full((n,), torch.inf, device=D.device))
    sortedD, order = torch.sort(Dm, dim=1, stable=True)
    finite = torch.isfinite(sortedD)
    remaining = torch.ones(n, dtype=torch.bool, device=D.device)
    selected = torch.empty(set_size, dtype=torch.int64, device=D.device)
    for t in range(-(-set_size // q)):
        # Pool at trip start: everyone (alive) minus the t q already
        # selected.
        if mask is None:
            pool, k = remaining, users_count - t * q - f - p
        else:
            pool = remaining & mask
            k = torch.clamp(pool.sum() - f - p, min=1)
        alive_cols = pool[order]                         # (n, n) gather
        rank = torch.cumsum(alive_cols, dim=1)           # 1-based in pool
        take = alive_cols & (rank <= k) & finite
        scores = torch.where(take, sortedD, 0.0).sum(1)
        if mask is not None:
            scores = torch.where(pool, scores, _DEAD_SENTINEL)
        scores = torch.where(remaining, scores, torch.inf)
        if q == 1:
            idx = torch.argmin(scores)                  # ties -> lowest index
            selected[t] = idx
            remaining[idx] = False
            continue
        r = min(q, set_size - t * q)
        idx = torch.sort(scores, stable=True).indices[:r]
        selected[t * q:t * q + r] = idx
        remaining[idx] = False
    return selected


def bulyan(users_grads, users_count, corrupted_count, paper_scoring=False,
           mask=None, weights=None, distance_dtype=None, batch_select=1):
    """Bulyan (reference defences.py:55-70): select n - 2f gradients by
    iterated Krum, then the median-anchored trimmed mean of the selection
    keeping set_size - 2f - 1 values per coordinate.  The distances are
    :func:`distances_for`'s; ``batch_select`` as for
    :func:`bulyan_select`.

    With ``mask``: the selection runs over the alive pool, then only the
    first e - 2f alive picks enter the trimmed mean (as a run over the
    alive sub-matrix would select them), which keeps max(|picks| - 2f - 1,
    1) values per coordinate, the mean weighted by ``weights`` if given."""
    check_weight_seam(mask, weights)
    f = corrupted_count
    set_size = users_count - 2 * f
    D = distances_for(users_grads, distance_dtype)
    selected = bulyan_select(D, users_count, f, paper_scoring, mask,
                             batch_select)
    selection = users_grads[selected].contiguous()  # (set_size, d)
    if mask is None:
        return trimmed_mean_of(selection, set_size - 2 * f - 1)
    sel_alive = mask[selected]
    sel_mask = sel_alive & (torch.cumsum(sel_alive, 0) <= mask.sum() - 2 * f)
    w_sel = None if weights is None else weights[selected].contiguous()
    return masked_trimmed_mean(selection, sel_mask, 2 * f + 1, w_sel)


# defenses/median.py adds "Median" when the package is imported.
DEFENSES = {"NoDefense": no_defense, "Krum": krum,
            "TrimmedMean": trimmed_mean, "Bulyan": bulyan}


def check_defense_args(name, users_count, corrupted_count):
    """Host-side guards mirroring the reference asserts (defences.py:25
    n >= 2f+1 for Krum; defences.py:56 n >= 4f+3 for Bulyan)."""
    if name == "Krum" and users_count < 2 * corrupted_count + 1:
        raise ValueError(
            f"Krum requires users_count >= 2*corrupted_count + 1 "
            f"(got n={users_count}, f={corrupted_count})")
    if name == "Bulyan" and users_count < 4 * corrupted_count + 3:
        raise ValueError(
            f"Bulyan requires users_count >= 4*corrupted_count + 3 "
            f"(got n={users_count}, f={corrupted_count})")
