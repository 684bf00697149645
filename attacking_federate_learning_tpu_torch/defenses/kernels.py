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

On a CUDA tensor every kernel call launches the CUDA kernel; on a CPU
tensor the same calls take the kernels' plain PyTorch versions.  The
selection loop and the sort fallback are plain tensor code on both, as
they are plain XLA in the JAX package.

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

import torch

from attacking_federate_learning_tpu_torch.ops.defense_kernels import (
    krum_complement, krum_scores, trimmed_mean_of
)
from attacking_federate_learning_tpu_torch.ops.distances import (
    pairwise_distances
)

# topk cancellation guard: required ratio of a row's kept score mass to
# the complement subtraction's noise floor (eps * log2(n) * rowsum).
# 1e4 keeps the relative score error under ~1e-4 whenever the complement
# identity is used; below that the scores come from the exact sort.
_TOPK_GUARD = 1e4


def no_defense(users_grads, users_count, corrupted_count):
    """Plain FedAvg mean (reference defences.py:13-14)."""
    return users_grads.mean(0)


def sort_scores(D, users_count, corrupted_count, paper_scoring=False):
    """Exact Krum scores from a zero-diagonal distance matrix: sort each
    row (self-distance at +inf, so it never counts) and sum the k =
    users_count - corrupted_count (- 2 paper) smallest entries."""
    n = D.shape[0]
    Dm = D + torch.diag(torch.full((n,), torch.inf, device=D.device))
    k = users_count - corrupted_count - (2 if paper_scoring else 0)
    srt = torch.sort(Dm, dim=1).values
    prefix = (torch.arange(n, device=D.device) < k)[None, :] & torch.isfinite(
        srt)
    return torch.where(prefix, srt, 0.0).sum(1)


def guarded_krum_scores(users_grads, users_count, corrupted_count,
                        paper_scoring=False):
    """The fused kernel's scores under the cancellation guard of the JAX
    package's ``_pallas_krum_scores_guarded``: the fused evaluation is the
    complement identity (rowsum minus the c largest), so whenever a row's
    kept mass falls below the subtraction's noise floor, or a rowsum is
    not finite, the scores are re-evaluated exactly by sorting the
    distance matrix.  c == 0 is the pure rowsum: no subtraction, no
    guard.  The guard's decision is one device-to-host read."""
    scores, rowsum = krum_scores(users_grads, corrupted_count, paper_scoring)
    n = users_grads.shape[0]
    if krum_complement(n, corrupted_count, paper_scoring) == 0:
        return scores
    eps = torch.finfo(torch.float32).eps
    floor = _TOPK_GUARD * eps * max(math.log2(max(n, 2)), 1.0) * rowsum
    reliable = bool(((scores >= floor) & torch.isfinite(rowsum)).all())
    if reliable:
        return scores
    return sort_scores(pairwise_distances(users_grads), users_count,
                       corrupted_count, paper_scoring)


def krum_select(users_grads, users_count, corrupted_count,
                paper_scoring=False, method="sort"):
    """Index (0-d tensor) of the Krum winner (reference ``krum(...,
    return_index=True)``, defences.py:39-40).  ``method='sort'`` scores
    exactly from the distance kernel's matrix; ``'fused'`` uses the fused
    score kernel under its guard (what the engine runs)."""
    if method == "sort":
        scores = sort_scores(pairwise_distances(users_grads), users_count,
                             corrupted_count, paper_scoring)
    elif method == "fused":
        scores = guarded_krum_scores(users_grads, users_count,
                                     corrupted_count, paper_scoring)
    else:
        raise ValueError(f"method must be 'sort' or 'fused', got {method!r}")
    return torch.argmin(scores)


def krum(users_grads, users_count, corrupted_count, paper_scoring=False,
         method="sort"):
    """Krum (reference defences.py:23-42): the single gradient whose summed
    distance to its k nearest peers is minimal."""
    idx = krum_select(users_grads, users_count, corrupted_count,
                      paper_scoring=paper_scoring, method=method)
    return users_grads[idx]


def trimmed_mean(users_grads, users_count, corrupted_count):
    """Reference defences.py:44-52; keeps n - f - 1 coordinates."""
    return trimmed_mean_of(users_grads,
                           users_grads.shape[0] - corrupted_count - 1)


def bulyan_select(D, users_count, corrupted_count, paper_scoring=False):
    """Bulyan's selection (reference defences.py:55-68) over a zero-diagonal
    distance matrix: set_size = n - 2f rounds of Krum, each removing its
    winner from the pool, with the pool size (but not f) shrinking.

    Each row is sorted once; a round's score is the alive-masked prefix sum
    of its k smallest entries over the presorted row — the same multiset
    of k smallest as a re-sort, so the same scores.  Returns the (set_size,)
    int64 selected indices in selection order, on D's device, with no
    host synchronization."""
    n = D.shape[0]
    f = corrupted_count
    set_size = users_count - 2 * f
    Dm = D + torch.diag(torch.full((n,), torch.inf, device=D.device))
    sortedD, order = torch.sort(Dm, dim=1, stable=True)
    finite = torch.isfinite(sortedD)
    alive = torch.ones(n, dtype=torch.bool, device=D.device)
    selected = torch.empty(set_size, dtype=torch.int64, device=D.device)
    for t in range(set_size):
        # Pool at round start: everyone minus the t already selected.
        k = users_count - t - f - (2 if paper_scoring else 0)
        alive_cols = alive[order]                        # (n, n) gather
        rank = torch.cumsum(alive_cols, dim=1)           # 1-based among alive
        take = alive_cols & (rank <= k) & finite
        scores = torch.where(take, sortedD, 0.0).sum(1)
        scores = torch.where(alive, scores, torch.inf)
        idx = torch.argmin(scores)                      # ties -> lowest index
        selected[t] = idx
        alive[idx] = False
    return selected


def bulyan(users_grads, users_count, corrupted_count, paper_scoring=False):
    """Bulyan (reference defences.py:55-70): select n - 2f gradients by
    iterated Krum, then the median-anchored trimmed mean of the selection
    keeping set_size - 2f - 1 values per coordinate."""
    f = corrupted_count
    set_size = users_count - 2 * f
    D = pairwise_distances(users_grads)
    selected = bulyan_select(D, users_count, f, paper_scoring)
    selection = users_grads[selected].contiguous()  # (set_size, d)
    return trimmed_mean_of(selection, set_size - 2 * f - 1)


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
