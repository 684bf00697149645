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

Three more seams ride along, the JAX package's observatories, each a
Python flag, so that with all of them off a defense runs exactly the
operations it runs without them:

- ``telemetry=True`` returns ``(aggregate, diagnostics)``, a small dict
  of fixed-shape device tensors (selection masks and scores for
  Krum/Bulyan, kept and trim fractions for the trimmed mean, distances
  to the aggregate for the median, ...).  The trimmed-mean kernel
  returns only its aggregate, as the JAX package's Pallas kernel does,
  so ``kept_fraction`` is NaN there and the real value comes as
  ``margin_kept_frac``.
- ``margins=True`` (needs ``telemetry``) adds the decision margins of
  utils/margins.py: Krum's from the same score vector the selection
  read (one fused-kernel launch), the trimmed mean's and the median's
  from rank ops beside the kernel (one median-kernel launch for the
  trimmed mean's anchor), Bulyan's carried through its selection loop.
- ``numerics=True`` (needs ``margins``) adds the tie-proximity and
  cancellation counters of utils/numerics.py, which band the margins.

The aggregate and every selection are the same bits with the seams on
or off.

On a CUDA tensor every kernel call launches the CUDA kernel; on a CPU
tensor the same calls take the kernels' plain PyTorch versions.  The
selection loop and the sort fallback are plain tensor code on both, as
they are plain XLA in the JAX package.

The host engines (defenses/host.py and the native library, native/) are
the JAX package's ``'host'`` routes, taken only where the caller names
them (``distance_impl``, ``selection_impl``, ``trim_impl``, ``impl``):
Krum's winner or the whole of Bulyan from the (n, d) matrix copied to the
host; Bulyan's hybrid exact selection, the distance kernel's (n, n)
matrix copied to the host once for the native incremental selection, the
gather and the trim back on the device; the coordinate-wise trimmed mean
and median from the native column-blocked kernels.  A copy from the card
goes through a pinned buffer (:func:`host_array`).  The host engines have
no mask seam and no per-row scores, so ``mask`` and ``margins`` are
refused there with the JAX package's messages, and Krum's telemetry
reports NaN scores; 'auto', 'xla' and 'pallas' all name the device suite.

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

import numpy as np
import torch

from attacking_federate_learning_tpu_torch.defenses import host as H
from attacking_federate_learning_tpu_torch.ops.defense_kernels import (
    krum_complement, krum_rows, krum_scores, masked_median,
    masked_trimmed_mean, median_of, trimmed_mean_of
)
from attacking_federate_learning_tpu_torch.ops.distances import (
    pairwise_distances
)
from attacking_federate_learning_tpu_torch.utils.costs import (
    KernelCost, counted_kernel
)
from attacking_federate_learning_tpu_torch.utils.margins import (
    krum_margins, rank_keep_margins, stable_argsort
)
from attacking_federate_learning_tpu_torch.utils.numerics import (
    cancellation_bits, gram_cancellation_bits, max_finite_abs, row_norms,
    tie_proximity
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

# The engine values of the impl knobs: 'auto', 'xla' and 'pallas' name the
# device suite, 'host' the host engines.
IMPLS = ("auto", "xla", "pallas", "host")


def check_impl(name, impl, allowed=IMPLS):
    """Refuse an impl value the defense has no route for."""
    if impl not in allowed:
        raise ValueError(f"{name} must be one of {allowed}, got {impl!r}")


# --- the host engines' seams ----------------------------------------------

def host_array(t) -> np.ndarray:
    """``t`` as a host f32 numpy array: on the CPU a view of it; from the
    card one copy through a pinned staging buffer, waited for."""
    t = t.float().contiguous()
    if t.device.type == "cpu":
        return t.numpy()
    buf = torch.empty(t.shape, dtype=torch.float32, pin_memory=True)
    buf.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return buf.numpy()


def _rows_cost(G, *_, **__) -> KernelCost:
    """An (n, d) matrix copied to the host and an (n, n) Gram there."""
    n, d = G.shape
    return KernelCost(2.0 * n * n * d, 4.0 * n * d, "host")


def _coord_cost(G, *_, **__) -> KernelCost:
    """An (n, d) matrix copied to the host, a selection per coordinate,
    the (d,) result copied back."""
    n, d = G.shape
    return KernelCost(float(n * d), 4.0 * (n * d + d), "host")


def _selection_cost(Dm, *_, **__) -> KernelCost:
    """The (n, n) matrix copied to the host and sorted row by row; the
    native selection is O(n^2) beside it."""
    n = Dm.shape[0]
    return KernelCost(n * n * max(1.0, math.log2(max(n, 2))),
                      4.0 * n * n, "host")


@counted_kernel("host_krum_index", _rows_cost)
def host_krum_select(users_grads, users_count, corrupted_count,
                     paper_scoring=False) -> int:
    """Krum's winner by the host engine (defenses/host.py:
    host_krum_index) over the (n, d) matrix copied to the host, the JAX
    package's ``distance_impl='host'``."""
    return H.host_krum_index(host_array(users_grads), int(users_count),
                             int(corrupted_count),
                             paper_scoring=paper_scoring)


@counted_kernel("host_bulyan", _rows_cost)
def host_bulyan_of(users_grads, users_count, corrupted_count,
                   paper_scoring=False, batch_select=1):
    """Bulyan's aggregate by the full host engine (defenses/host.py:
    host_bulyan), back on ``users_grads``' device as (d,) f32."""
    agg = H.host_bulyan(host_array(users_grads), int(users_count),
                        int(corrupted_count), paper_scoring=paper_scoring,
                        batch_select=batch_select)
    return torch.from_numpy(agg).to(users_grads.device)


@counted_kernel("host_bulyan_selection", _selection_cost)
def host_bulyan_selection_of(Dm, users_count, corrupted_count, set_size,
                             batch_select=1, paper_scoring=False):
    """The hybrid's host half: the (n, n) distance matrix ``Dm`` (+inf
    diagonal) copied to the host once, the native exact selection there
    (defenses/host.py:host_bulyan_selection), the (set_size,) indices
    back on ``Dm``'s device as int64."""
    sel = H.host_bulyan_selection(host_array(Dm), int(users_count),
                                  int(corrupted_count), int(set_size),
                                  batch_select=int(batch_select),
                                  paper_scoring=paper_scoring)
    return torch.from_numpy(sel.astype(np.int64)).to(Dm.device)


@counted_kernel("host_trimmed_mean", _coord_cost)
def host_trimmed_mean_of(users_grads, number_to_consider):
    """The median-anchored trimmed mean keeping ``number_to_consider``
    values a coordinate, by the native column-blocked kernel
    (defenses/host.py:host_trimmed_mean_of) over the matrix copied to the
    host; (d,) f32 back on its device."""
    agg = H.host_trimmed_mean_of(host_array(users_grads),
                                 int(number_to_consider))
    return torch.from_numpy(agg).to(users_grads.device)


@counted_kernel("host_median", _coord_cost)
def host_median_of(users_grads):
    """The coordinate-wise median by the native column-blocked kernel
    (defenses/host.py:host_median) over the matrix copied to the host;
    (d,) f32 back on its device."""
    agg = H.host_median(host_array(users_grads))
    return torch.from_numpy(agg).to(users_grads.device)


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


def check_margin_seam(margins, telemetry):
    """The ``margins=`` seam rides the telemetry diagnostics: margins
    without telemetry have no carrier and are a caller bug (the engine
    passes telemetry=True whenever margins are on, and filters the other
    diagnostics out when --telemetry is off)."""
    if margins and not telemetry:
        raise ValueError(
            "defense margins=True requires telemetry=True (margin "
            "fields ride the diagnostics pytree; utils/margins.py)")


def check_numerics_seam(numerics, margins):
    """The ``numerics=`` seam rides the margin tensors: the tie counters
    band the margins, so numerics without margins have nothing to band
    and are a caller bug (the engine passes margins=True whenever the
    kernel numerics are on)."""
    if numerics and not margins:
        raise ValueError(
            "defense numerics=True requires margins=True (tie counters "
            "band the margin tensors; utils/numerics.py)")


def check_seams(mask, weights, telemetry, margins, numerics):
    check_weight_seam(mask, weights)
    check_margin_seam(margins, telemetry)
    check_numerics_seam(numerics, margins)


def population_telemetry(users_grads):
    """Per-client update norms and cosine to the mean: the population
    view the server can always observe, whichever defense runs.  Two
    (n,) f32 vectors."""
    G = users_grads.float()
    norms = row_norms(G)
    mean = G.mean(0)
    cos = (G @ mean) / (norms * row_norms(mean) + 1e-12)
    return {"client_norms": norms, "cosine_to_mean": cos}


def scatter_rows(n, idx, values, like):
    """An (n,) f32 vector, ``values`` at rows ``idx`` and 0 elsewhere."""
    out = torch.zeros(n, dtype=torch.float32, device=like.device)
    out[idx] = values
    return out


def no_defense(users_grads, users_count, corrupted_count, mask=None,
               weights=None, telemetry=False, margins=False,
               numerics=False):
    """Plain FedAvg mean (reference defences.py:13-14); with ``mask`` the
    mean of the alive rows (a zeroed dropout row must not drag it toward
    zero), with ``weights`` the weighted alive mean sum(w g) / sum(w).
    A mean has no decision to measure: its diagnostics are empty and
    ``margins`` / ``numerics`` are accepted and ignored."""
    check_seams(mask, weights, telemetry, margins, numerics)
    if weights is not None:
        w = torch.where(mask, weights, 0.0)
        agg = (w @ users_grads.float()) / torch.clamp(w.sum(), min=1e-12)
    elif mask is None:
        # The sums run in f32 and round to the wire's dtype once
        # (jnp.mean and jnp.sum of a bf16 matrix).
        agg = users_grads.mean(0, dtype=torch.float32).to(users_grads.dtype)
    else:
        e = torch.clamp(mask.sum(), min=1)
        agg = torch.where(mask[:, None], users_grads, 0.0).sum(
            0, dtype=torch.float32).to(users_grads.dtype) / e
    return (agg, {}) if telemetry else agg


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
    return _guarded(scores, rowsum, users_count, corrupted_count,
                    paper_scoring,
                    lambda: distances_for(users_grads, distance_dtype))


def _guarded(scores, rowsum, users_count, corrupted_count, paper_scoring,
             distances):
    """The cancellation guard on the complement identity's (scores,
    rowsum): the scores where every row's kept mass clears the
    subtraction's noise floor (or c == 0), else the exact sort of
    ``distances()``."""
    n = scores.shape[0]
    if krum_complement(n, corrupted_count, paper_scoring) == 0:
        return scores
    eps = torch.finfo(torch.float32).eps
    floor = _TOPK_GUARD * eps * max(math.log2(max(n, 2)), 1.0) * rowsum
    reliable = bool(((scores >= floor) & torch.isfinite(rowsum)).all())
    if reliable:
        return scores
    return sort_scores(distances(), users_count, corrupted_count,
                       paper_scoring)


def guarded_scores_of(D, users_count, corrupted_count, paper_scoring=False):
    """:func:`guarded_krum_scores` on a distance matrix computed
    elsewhere (the model axis' split Gram): kernel 2's per-row selection
    (ops/defense_kernels.py:krum_rows) under the same guard, the exact
    sort of ``D`` where it fails or where c < 0."""
    if corrupted_count - 1 + (2 if paper_scoring else 0) < 0:
        return sort_scores(D, users_count, corrupted_count, paper_scoring)
    comp = krum_complement(D.shape[0], corrupted_count, paper_scoring)
    scores, rowsum = krum_rows(D, comp)
    return _guarded(scores, rowsum, users_count, corrupted_count,
                    paper_scoring, lambda: D)


def krum_scores_and_index(users_grads, users_count, corrupted_count,
                          paper_scoring=False, method="sort", mask=None,
                          distance_dtype=None, distance_impl="auto", D=None):
    """The (n,) f32 Krum scores and the winner's index (a 0-d tensor)
    behind both :func:`krum_select` and Krum's diagnostics.
    ``method='sort'`` scores the distance kernel's matrix exactly by
    sort; ``'fused'`` uses the fused score kernel under its guard (what
    the engine runs, as the JAX package's Pallas route does).  With
    ``mask`` both score exactly by sort over the distance kernel, with k
    following the alive count e - f, and a dead row never wins.
    ``distance_dtype`` as for :func:`distances_for` and
    :func:`guarded_krum_scores`.  ``distance_impl='host'`` takes the
    winner from the host engine (:func:`host_krum_select`), which returns
    no scores: None in their place, and no mask seam.  ``D``, a distance
    matrix computed elsewhere (the blockwise schedules over a mesh,
    parallel/distances.py), outranks both: the scores are its exact
    sort, as in the JAX package."""
    if method not in ("sort", "fused"):
        raise ValueError(f"method must be 'sort' or 'fused', got {method!r}")
    check_impl("distance_impl", distance_impl)
    if D is not None:
        e = users_count if mask is None else mask.sum()
        scores = sort_scores(D, e, corrupted_count, paper_scoring,
                             alive=mask)
        return scores, torch.argmin(scores)
    if distance_impl == "host":
        if mask is not None:
            raise ValueError(
                "mask-aware Krum needs a score-returning engine; "
                "the host engine returns only the winner index "
                "(defenses/host.py)")
        idx = host_krum_select(users_grads, users_count, corrupted_count,
                               paper_scoring)
        return None, torch.tensor(idx, device=users_grads.device)
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
    return scores, torch.argmin(scores)


def krum_select(users_grads, users_count, corrupted_count,
                paper_scoring=False, method="sort", mask=None,
                distance_dtype=None, distance_impl="auto", D=None):
    """Index (0-d tensor) of the Krum winner (reference ``krum(...,
    return_index=True)``, defences.py:39-40); the arguments are
    :func:`krum_scores_and_index`'s."""
    return krum_scores_and_index(users_grads, users_count, corrupted_count,
                                 paper_scoring, method, mask,
                                 distance_dtype, distance_impl, D)[1]


def krum(users_grads, users_count, corrupted_count, paper_scoring=False,
         method="sort", mask=None, weights=None, distance_dtype=None,
         distance_impl="auto", telemetry=False, margins=False,
         numerics=False, D=None):
    """Krum (reference defences.py:23-42): the single gradient whose summed
    distance to its k nearest peers is minimal; with ``mask`` the Krum
    choice of the alive rows, with ``weights`` scaled by its weight.

    Diagnostics: ``selection_mask`` (n,) one-hot and ``scores`` (n,),
    from the one score evaluation the selection read; with ``margins``
    ``margin_selection`` (n,) and ``margin_gap`` ()
    (utils/margins.py:krum_margins); with ``numerics`` ``num_tie_rows``
    (), the rows whose margin sits within TIE_BAND_ULPS ulp of the
    boundary at the winning score's scale, and ``num_cancel_bits`` (),
    an estimate of the cancellation depth: 2 max ||g||^2 against the
    winner's mean kept distance.  Under ``distance_impl='host'`` the
    scores are NaN and margins are refused: the host engine returns only
    the winner.  ``D`` as for :func:`krum_scores_and_index`."""
    check_seams(mask, weights, telemetry, margins, numerics)
    scores, idx = krum_scores_and_index(
        users_grads, users_count, corrupted_count, paper_scoring, method,
        mask, distance_dtype, distance_impl, D)
    agg = (users_grads[idx] * weights[idx] if weights is not None
           else users_grads[idx])
    if not telemetry:
        return agg
    n = users_grads.shape[0]
    scores = (torch.full((n,), torch.nan, device=users_grads.device)
              if scores is None else scores.float())
    diag = {"selection_mask": scatter_rows(n, idx, 1.0, scores),
            "scores": scores}
    if margins and distance_impl == "host":
        raise ValueError(
            "Krum margins need a score-returning engine; "
            "distance_impl='host' returns only the winner index "
            "(defenses/host.py)")
    if margins:
        diag.update(krum_margins(scores, idx, mask=mask))
        if numerics:
            win = scores[idx]
            diag["num_tie_rows"] = tie_proximity(diag["margin_selection"],
                                                 win)
            e = users_count if mask is None else mask.sum()
            k_kept = torch.clamp(torch.as_tensor(e - corrupted_count),
                                 min=1).float()
            g32 = users_grads.float()
            sq = (g32 * g32).sum(1)
            if mask is not None:
                sq = torch.where(mask, sq, 0.0)
            diag["num_cancel_bits"] = cancellation_bits(
                2.0 * sq.max(), win / k_kept.to(win.device))
    return agg, diag


def trim_margins(users_grads, med, keep, mask=None, numerics=False,
                 order=None):
    """The trimmed mean's margins (utils/margins.py:rank_keep_margins)
    over the key |G - med| it ranks by (dead rows at +inf), with the tie
    counter banded at the key's largest finite magnitude."""
    key = (users_grads.float() - med.float()[None, :]).abs()
    if mask is not None:
        key = torch.where(mask[:, None], key, torch.inf)
    mf = rank_keep_margins(key, keep, order=order)
    if numerics:
        mf["num_tie_rows"] = tie_proximity(mf["margin_boundary_dist"],
                                           max_finite_abs(key))
    return mf


def trimmed_mean(users_grads, users_count, corrupted_count, mask=None,
                 weights=None, impl="xla", telemetry=False, margins=False,
                 numerics=False):
    """Reference defences.py:44-52; keeps n - f - 1 coordinates.  With
    ``mask`` the estimator of the alive rows, keeping e - f - 1 (at least
    1) of the e alive values, the mean weighted by ``weights`` if given.
    ``impl='host'`` is the native column-blocked kernel
    (:func:`host_trimmed_mean_of`; summation-order ulps from the device
    kernel), which has no mask seam and no ranks for margins.

    Diagnostics: ``kept_fraction`` (n,), NaN (the kernel returns only
    the aggregate), and ``trim_fraction`` (); with ``margins``
    ``margin_kept_frac`` and ``margin_boundary_dist`` over the key the
    kernel ranks by, anchored at the median kernel's (the masked median
    kernel's) median; with ``numerics`` ``num_tie_rows``."""
    check_seams(mask, weights, telemetry, margins, numerics)
    check_impl("impl", impl)
    n = users_grads.shape[0]
    if mask is not None and impl == "host":
        raise ValueError(
            "mask-aware TrimmedMean has no host kernel "
            "(defenses/host.py is maskless); use impl='xla'")
    if impl == "host" and margins:
        raise ValueError(
            "trimmed-mean margins need the on-device ranks; "
            "impl='host' returns only the aggregate "
            "(defenses/host.py)")
    if mask is not None:
        agg = masked_trimmed_mean(users_grads, mask, corrupted_count + 1,
                                  weights)
        if not telemetry:
            return agg
        e = mask.sum()
        keep = e - corrupted_count - 1
        diag = {"kept_fraction": torch.full((n,), torch.nan,
                                            device=users_grads.device),
                "trim_fraction": (1.0 - keep / torch.clamp(e, min=1)
                                  ).float()}
        if margins:
            med = masked_median(users_grads, mask)
            diag.update(trim_margins(users_grads, med,
                                     torch.clamp(keep, min=1), mask,
                                     numerics))
        return agg, diag
    keep = n - corrupted_count - 1
    agg = trim_of(users_grads, keep, impl)
    if not telemetry:
        return agg
    diag = {"kept_fraction": torch.full((n,), torch.nan,
                                        device=users_grads.device),
            "trim_fraction": torch.tensor(float(np.float32(1.0 - keep / n)),
                                          device=users_grads.device)}
    if margins:
        diag.update(trim_margins(users_grads, median_of(users_grads), keep,
                                 numerics=numerics))
    return agg, diag


def trim_of(users_grads, keep, impl="xla"):
    """The unmasked trimmed mean keeping ``keep`` values a coordinate: the
    trimmed-mean kernel, or under ``impl='host'`` the native kernel."""
    if impl == "host":
        return host_trimmed_mean_of(users_grads, keep)
    return trimmed_mean_of(users_grads, keep)


def bulyan_select(D, users_count, corrupted_count, paper_scoring=False,
                  mask=None, batch_select=1, margins=False):
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
    selected rows sit at +inf.  The selection keeps its static size.

    ``margins=True`` returns ``(selected, carry)`` with the margin carries
    of the JAX loop: each trip ranks its scores by one stable sort (its
    first r entries the picks, ties and all, as without margins) and the
    next score is the trip's cut; ``carry`` holds ``margin`` (n,) (each
    pick's runner-up score minus its own), ``slack`` (trips,) (the cut
    minus the trip's last pick), ``cut`` (the last trip's last pick),
    ``scores`` (the last trip's scores) and ``remaining`` (the rows never
    picked)."""
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
    trips = -(-set_size // q)
    if margins:
        kk = min(q + 1, n)
        margin = torch.zeros(n, dtype=torch.float32, device=D.device)
        slack = torch.zeros(trips, dtype=torch.float32, device=D.device)
    for t in range(trips):
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
        r = min(q, set_size - t * q)
        if margins:
            ranked = stable_argsort(scores)
            vals, idx = scores[ranked], ranked[:r]
            runner, last_pick = vals[min(r, kk - 1)], vals[max(r - 1, 0)]
            margin[idx] = runner - vals[:r]
            slack[t] = runner - last_pick
        elif q == 1:
            idx = torch.argmin(scores)                  # ties -> lowest index
        else:
            idx = torch.sort(scores, stable=True).indices[:r]
        selected[t * q:t * q + r] = idx
        remaining[idx] = False
    if not margins:
        return selected
    return selected, {"margin": margin, "slack": slack, "cut": last_pick,
                      "scores": scores, "remaining": remaining}


def bulyan(users_grads, users_count, corrupted_count, paper_scoring=False,
           mask=None, weights=None, distance_dtype=None, batch_select=1,
           distance_impl="auto", selection_impl="xla", trim_impl="xla",
           telemetry=False, margins=False, numerics=False, D=None):
    """Bulyan (reference defences.py:55-70): select n - 2f gradients by
    iterated Krum, then the median-anchored trimmed mean of the selection
    keeping set_size - 2f - 1 values per coordinate.  The distances are
    :func:`distances_for`'s; ``batch_select`` as for
    :func:`bulyan_select`.

    With ``mask``: the selection runs over the alive pool, then only the
    first e - 2f alive picks enter the trimmed mean (as a run over the
    alive sub-matrix would select them), which keeps max(|picks| - 2f - 1,
    1) values per coordinate, the mean weighted by ``weights`` if given.

    Diagnostics: ``selection_mask`` (n,) multi-hot (the picks that enter
    the trim) and ``scores`` (n,), the initial pool's Krum scores; with
    ``margins`` ``margin_selection`` (n,) (each row against its trip's
    cut: picks against the first unselected score, the rest against the
    last trip's last pick; dead rows and picks clipped out of the
    effective selection -inf), ``margin_gap`` () (the last trip's
    slack), ``margin_slack`` (trips,) and ``margin_trim_kept`` (n,) (the
    trim stage's kept fraction of each pick at its client's row, 0
    elsewhere); with ``numerics`` ``num_tie_rows`` () at the last cut's
    scale and ``num_cancel_bits`` () of the distance matrix
    (utils/numerics.py:gram_cancellation_bits).

    The host engines, the JAX package's routes: ``distance_impl='host'``
    is the full host engine (:func:`host_bulyan_of`; telemetry NaN, the
    selection never comes back); ``selection_impl='host'`` the hybrid
    exact selection (:func:`host_bulyan_selection_of` over the distance
    kernel's matrix with its +inf diagonal; ties inside the native
    comparator's ulp band may go another way than the device loop's);
    ``trim_impl='host'`` the unmasked tail by the native kernel.  Neither
    host selection has a mask seam or per-trip scores for margins.  ``D``,
    a distance matrix computed elsewhere (the blockwise schedules over a
    mesh, parallel/distances.py), takes the distance kernel's place."""
    check_seams(mask, weights, telemetry, margins, numerics)
    check_impl("distance_impl", distance_impl)
    check_impl("selection_impl", selection_impl, ("xla", "host", "pallas"))
    check_impl("trim_impl", trim_impl, ("xla", "host", "pallas"))
    n = users_grads.shape[0]
    f = corrupted_count
    set_size = users_count - 2 * f
    if int(batch_select) < 1:
        raise ValueError(f"batch_select must be >= 1, got {batch_select}")
    if mask is not None and selection_impl == "host":
        raise ValueError(
            "mask-aware Bulyan is incompatible with "
            "selection_impl='host': the native selection engine has no "
            "mask seam (native/bulyan_select.cpp)")
    if distance_impl == "host" and selection_impl != "pallas" and D is None:
        if mask is not None:
            raise ValueError(
                "mask-aware Bulyan has no full-host engine "
                "(defenses/host.py is maskless)")
        if margins:
            raise ValueError(
                "Bulyan margins need the traced selection loop; "
                "the full-host engine returns only the aggregate "
                "(defenses/host.py)")
        agg = host_bulyan_of(users_grads, users_count, f, paper_scoring,
                             min(int(batch_select), set_size))
        if not telemetry:
            return agg
        nan = torch.full((n,), torch.nan, device=users_grads.device)
        return agg, {"selection_mask": nan, "scores": nan.clone()}
    if D is None:
        D = distances_for(users_grads, distance_dtype)
    if selection_impl == "host":
        if margins:
            raise ValueError(
                "Bulyan margins are incompatible with "
                "selection_impl='host': the native selection engine "
                "returns only the selected indices, never the per-trip "
                "scores the margins measure (native/bulyan_select.cpp)")
        Dm = D + torch.diag(torch.full((n,), torch.inf, device=D.device))
        selected = host_bulyan_selection_of(
            Dm, users_count, f, set_size, min(int(batch_select), set_size),
            paper_scoring)
    else:
        selected = bulyan_select(D, users_count, f, paper_scoring, mask,
                                 batch_select, margins=margins)
    if margins:
        selected, carry = selected
    selection = users_grads[selected].contiguous()  # (set_size, d)
    agg, sel_mask = bulyan_trim(selection, selected, set_size, f, mask,
                                weights, trim_impl)
    if mask is None:
        keep = set_size - 2 * f - 1
        if not telemetry:
            return agg
        diag = {"selection_mask": scatter_rows(n, selected, 1.0, D),
                "scores": sort_scores(D, users_count, f,
                                      paper_scoring).float()}
    else:
        if not telemetry:
            return agg
        diag = {"selection_mask": scatter_rows(n, selected,
                                               sel_mask.float(), D),
                "scores": sort_scores(D, mask.sum(), f, paper_scoring,
                                      alive=mask).float()}
    if not margins:
        return agg, diag
    # Rows never picked measure against the last trip's last pick.
    margin = torch.where(carry["remaining"],
                         carry["cut"] - carry["scores"], carry["margin"])
    if mask is None:
        tm = trim_margins(selection, median_of(selection), keep)
        trim_kept = tm["margin_kept_frac"]
    else:
        # Picks clipped out of the effective selection, and dead rows,
        # are rejected and unmeasured: -inf.
        clipped = torch.zeros(n, dtype=torch.bool, device=D.device)
        clipped[selected] = ~sel_mask
        margin = torch.where(clipped | ~mask, -torch.inf, margin)
        tm = trim_margins(selection, masked_median(selection, sel_mask),
                          torch.clamp(sel_mask.sum() - 2 * f - 1, min=1),
                          sel_mask)
        trim_kept = torch.where(sel_mask, tm["margin_kept_frac"], 0.0)
    slack = carry["slack"]
    diag.update(margin_selection=margin.float(), margin_gap=slack[-1],
                margin_slack=slack,
                margin_trim_kept=scatter_rows(n, selected, trim_kept, D))
    if numerics:
        diag["num_tie_rows"] = tie_proximity(margin, carry["cut"])
        Dm = D + torch.diag(torch.full((n,), torch.inf, device=D.device))
        diag["num_cancel_bits"] = gram_cancellation_bits(Dm, mask=mask)
    return agg, diag


def bulyan_trim(selection, selected, set_size, f, mask=None, weights=None,
                trim_impl="xla"):
    """Bulyan's tail on the selected rows ``selection`` (``selected``
    their indices): the trimmed mean keeping set_size - 2f - 1 values a
    coordinate, or with ``mask`` the masked one over the first e - 2f
    alive picks.  Per coordinate, so a model position runs it on its
    column block.  Returns (aggregate, the picks' mask or None)."""
    if mask is None:
        return trim_of(selection, set_size - 2 * f - 1, trim_impl), None
    sel_alive = mask[selected]
    sel_mask = sel_alive & (torch.cumsum(sel_alive, 0)
                            <= mask.sum() - 2 * f)
    w_sel = None if weights is None else weights[selected].contiguous()
    return (masked_trimmed_mean(selection, sel_mask, 2 * f + 1, w_sel),
            sel_mask)


# defenses/median.py adds "Median" when the package is imported.
DEFENSES = {"NoDefense": no_defense, "Krum": krum,
            "TrimmedMean": trimmed_mean, "Bulyan": bulyan}


# --- tier-2 (cross-shard) entries of the hierarchical round ---------------
#
# The hierarchical round (ops/federated.py, core/engine.py) reduces the
# per-megabatch tier-1 estimates with a second robust pass over the (S, d)
# shard-estimate matrix.  Each shard_* entry is the flat defense on that
# matrix: rows are shard estimates, ``shard_count`` plays users_count,
# ``corrupted_shards`` is the assumed number of colluder-controlled
# shards, and ``alive_counts`` (S,) int, each shard's effective cohort
# under faults, becomes the defenses' quarantine ``mask=`` (a shard with
# no alive row can never win a selection or enter a trim).  No new
# estimator and no new kernel: the flat defenses' kernels run at S rows.
# The observatory flags (``telemetry=``, ``margins=``, ``numerics=``) pass
# through: the diagnostics are the flat defense's, over the shard axis.

def _alive_to_mask(alive_counts):
    return None if alive_counts is None else alive_counts > 0


def shard_mean(shard_estimates, shard_count, corrupted_shards,
               alive_counts=None, telemetry=False, margins=False,
               numerics=False):
    """Tier-2 NoDefense: the alive-count-weighted mean of the shard
    estimates (with equal megabatches and no faults the flat mean up to
    the order of summation; with faults the weights restore the flat
    masked mean's per-client weighting).  A mean rejects nothing: its
    diagnostics are empty."""
    del shard_count, corrupted_shards
    check_seams(None, None, telemetry, margins, numerics)
    if alive_counts is None:
        agg = shard_estimates.mean(0)
    else:
        w = alive_counts.float()
        agg = (w @ shard_estimates) / torch.clamp(w.sum(), min=1.0)
    return (agg, {}) if telemetry else agg


def shard_krum(shard_estimates, shard_count, corrupted_shards,
               alive_counts=None, **kw):
    """Tier-2 Krum over shard estimates: the fused score kernel under its
    guard without faults, exact sort scoring over the alive shards with
    alive counts."""
    return krum(shard_estimates, shard_count, corrupted_shards,
                method="fused", mask=_alive_to_mask(alive_counts), **kw)


def shard_trimmed_mean(shard_estimates, shard_count, corrupted_shards,
                       alive_counts=None, **kw):
    """Tier-2 median-anchored trimmed mean over shard estimates."""
    return trimmed_mean(shard_estimates, shard_count, corrupted_shards,
                        mask=_alive_to_mask(alive_counts), **kw)


def shard_bulyan(shard_estimates, shard_count, corrupted_shards,
                 alive_counts=None, **kw):
    """Tier-2 Bulyan over shard estimates; its (S, S) distance pass is
    small."""
    return bulyan(shard_estimates, shard_count, corrupted_shards,
                  mask=_alive_to_mask(alive_counts), **kw)


def shard_median(shard_estimates, shard_count, corrupted_shards,
                 alive_counts=None, **kw):
    """Tier-2 coordinate-wise median over shard estimates."""
    # defenses/median.py imports this module.
    from attacking_federate_learning_tpu_torch.defenses.median import median
    return median(shard_estimates, shard_count, corrupted_shards,
                  mask=_alive_to_mask(alive_counts), **kw)


# The tier-2 names (config.tier2_defense); the hierarchical round's tier-1
# defense is restricted to the same mask-aware set.
TIER2_DEFENSES = {"NoDefense": shard_mean, "Krum": shard_krum,
                  "TrimmedMean": shard_trimmed_mean,
                  "Bulyan": shard_bulyan, "Median": shard_median}


def check_tier2_args(name, shard_count, corrupted_shards):
    """Validity of a tier's reduction: the Krum/Bulyan bounds of
    :func:`check_defense_args`, plus the trimmed mean's keep-count floor
    (S - f2 - 1 >= 1), which the flat round never meets since n >> f."""
    check_defense_args(name, shard_count, corrupted_shards)
    if (name in ("TrimmedMean",)
            and shard_count - corrupted_shards - 1 < 1):
        raise ValueError(
            f"tier-2 TrimmedMean keeps shard_count - corrupted_shards - 1 "
            f"estimates; got S={shard_count}, f2={corrupted_shards}")


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
