"""The host engines' NumPy/BLAS kernels, the port's copy of the JAX
package's ``defenses/host.py``: the semantics are the reference's exact
variants (reference defences.py:16-70) and the device kernels': Krum
scores sum the ``users_count - corrupted_count`` smallest distances (a sum
of a set, so ``np.partition`` replaces the full row sort); ties go to the
lowest index (first-occurrence ``np.argmin``, reference defences.py:35);
Bulyan's pool shrinks with each selection while f stays fixed, and
``batch_select`` q takes the q lowest scores a trip.

The engine reaches these only where the config names a host engine
(``distance_impl``, ``bulyan_selection_impl``, ``bulyan_trim_impl``,
``trimmed_mean_impl``, ``median_impl`` = 'host'; defenses/kernels.py).
The coordinate-wise kernels and the Bulyan selection call the native
library (native/); NumPy runs them only where the semantics ask for it:
a median or trimmed mean of a matrix with a non-finite value is NumPy's
(NaN propagates there; ``std::nth_element`` on NaN is undefined).  A
failed native build or call raises.  :func:`numpy_bulyan_selection` is
the selection's plain version, which the tests hold the native one
against; no route falls back to it.
"""

from __future__ import annotations

import numpy as np


def host_sq_distances(G: np.ndarray) -> np.ndarray:
    """(n, d) f32 -> (n, n) squared Euclidean distances, +inf diagonal.

    One BLAS Gram matmul + in-place epilogue — the same
    ``||g_i||^2 + ||g_j||^2 - 2 G G^T`` decomposition as the distance kernel
    (ops/distances.py), so both paths compute identical values to f32
    tolerance.  The squared norms are read off the Gram diagonal (they ARE
    the diagonal), saving a full O(n d) pass, and the epilogue mutates the
    Gram buffer so no second n^2 array is allocated."""
    gram = G @ G.T
    sq = gram.diagonal().copy()
    gram *= -2.0
    gram += sq[:, None]
    gram += sq[None, :]
    np.maximum(gram, 0.0, out=gram)
    np.fill_diagonal(gram, np.inf)
    return gram


def host_pairwise_distances(G: np.ndarray) -> np.ndarray:
    """(n, d) f32 -> (n, n) Euclidean distances with +inf diagonal."""
    d2 = host_sq_distances(G)
    D = np.sqrt(d2, out=d2)
    np.fill_diagonal(D, np.inf)  # sqrt(inf) is inf, but keep it explicit
    return D


def _prefix_scores(sortedD, order, finite, alive, pool, f,
                   paper_scoring=False):
    """Sum of the k smallest alive distances per row, evaluated as an
    alive-masked rank prefix over presorted rows (same presort-once
    scheme as the device Bulyan, defenses/kernels.py); +inf for dead rows.
    k = pool - f, or pool - f - 2 under paper scoring (SURVEY.md §2.4
    #4)."""
    k = pool - f - (2 if paper_scoring else 0)
    alive_cols = alive[order]
    rank = np.cumsum(alive_cols, axis=1)
    take = alive_cols & (rank <= k) & finite
    scores = np.where(take, sortedD, 0.0).sum(axis=1)
    scores[~alive] = np.inf
    return scores


def host_krum_index(G, users_count, corrupted_count, paper_scoring=False):
    """Krum winner index (reference defences.py:23-42 semantics,
    ``return_index=True`` shape).

    Selection of the k nearest peers happens on *squared* distances
    (monotone in the true distance), so the sqrt runs only over the n*k
    selected entries instead of the full n^2 matrix; the score itself sums
    the square-rooted values, identical to the reference's norm sum."""
    G = np.asarray(G, np.float32)
    n = G.shape[0]
    d2 = host_sq_distances(G)
    k = users_count - corrupted_count - (2 if paper_scoring else 0)
    k = max(min(k, n - 1), 0)
    if k == 0:
        return 0
    part = np.partition(d2, k - 1, axis=1)[:, :k]
    scores = np.sqrt(part, out=part).sum(axis=1)
    return int(np.argmin(scores))


def host_krum(G, users_count, corrupted_count, paper_scoring=False):
    """Krum winner row."""
    G = np.asarray(G, np.float32)
    return G[host_krum_index(G, users_count, corrupted_count,
                             paper_scoring=paper_scoring)]


def _all_finite(a: np.ndarray) -> bool:
    """Full-finiteness check without materializing an (n, d) bool temp
    (420 MB at the 10k north-star tail): two scalar reductions — NaN
    propagates through min/max, ±inf is its own extremum."""
    return bool(np.isfinite(a.min()) and np.isfinite(a.max()))


def host_median(sel: np.ndarray):
    """Coordinate-wise median: the native column-blocked kernel when the
    input is fully finite, ``np.median`` (which propagates NaN) when it
    is not."""
    sel = np.asarray(sel, np.float32)
    if sel.size and _all_finite(sel):
        from attacking_federate_learning_tpu_torch.native import (
            native_median
        )
        return native_median(sel)
    return np.median(sel, axis=0).astype(np.float32)


def host_trimmed_mean_of(sel: np.ndarray, number_to_consider: int):
    """Median-anchored trimmed mean (reference defences.py:48-51), stable
    order on |deviation| to match Python's stable ``sorted``: the native
    column-blocked kernel (native/bulyan_select.cpp:fl_trimmed_mean) when
    0 < k <= n and the input is fully finite, the NumPy formulation (which
    propagates NaN) otherwise.  Both keep the boundary ties' lowest rows
    and differ by summation-order ulps."""
    sel = np.asarray(sel, np.float32)
    k = int(number_to_consider)
    if 0 < k <= sel.shape[0] and sel.size and _all_finite(sel):
        from attacking_federate_learning_tpu_torch.native import (
            native_trimmed_mean
        )
        return native_trimmed_mean(sel, k)
    med = np.median(sel, axis=0)
    dev = sel - med
    order = np.argsort(np.abs(dev), axis=0, kind="stable")
    kept = np.take_along_axis(dev, order[:k], axis=0)
    return (kept.mean(axis=0) + med).astype(np.float32)


def numpy_bulyan_selection(D, order, users_count, corrupted_count,
                           set_size, batch_select=1, paper_scoring=False):
    """The selection's plain version: presort once, alive-masked rank
    prefixes, O(n^2) scoring a trip."""
    n = D.shape[0]
    f = corrupted_count
    q = min(max(int(batch_select), 1), set_size)
    sortedD = np.take_along_axis(D, order, axis=1)
    finite = np.isfinite(sortedD)
    alive = np.ones(n, bool)
    selected = []
    while len(selected) < set_size:
        r = min(q, set_size - len(selected))
        scores = _prefix_scores(sortedD, order, finite, alive,
                                users_count - len(selected), f,
                                paper_scoring=paper_scoring)
        idxs = np.argsort(scores, kind="stable")[:r]
        selected.extend(int(i) for i in idxs)
        alive[idxs] = False
    return np.asarray(selected, np.int32)


def host_bulyan_selection(D, users_count, corrupted_count, set_size,
                          batch_select=1, paper_scoring=False):
    """Selected client indices over the (n, n) distance matrix ``D``
    (+inf diagonal), in selection order, from the native incremental
    kernel (native/bulyan_select.cpp: O(n^2) in all instead of O(n^2) a
    selection, which makes exact q = 1 tractable at n = 10,000).  Its
    scores are alive-prefix sums over each presorted row, the same
    whatever the order of equal values inside the sort, and selection
    ties go to the lowest client index, as in
    :func:`numpy_bulyan_selection`."""
    order = np.argsort(D, axis=1).astype(np.int32, copy=False)
    from attacking_federate_learning_tpu_torch.native import (
        native_bulyan_selection
    )
    return native_bulyan_selection(D, order, users_count, corrupted_count,
                                   set_size, batch_select=batch_select,
                                   paper_scoring=paper_scoring)


def host_bulyan(G, users_count, corrupted_count, paper_scoring=False,
                batch_select=1):
    """Bulyan (reference defences.py:55-70) on the host: iterated Krum
    selection with a shrinking pool, then the trimmed mean with parameter
    2f.  ``batch_select`` q > 1 takes the q lowest scores a trip against
    the same scores (the device loop's flagged relaxation); q = 1 is the
    reference's."""
    G = np.asarray(G, np.float32)
    f = corrupted_count
    set_size = users_count - 2 * f
    D = host_pairwise_distances(G)
    selected = host_bulyan_selection(D, users_count, f, set_size,
                                     batch_select=batch_select,
                                     paper_scoring=paper_scoring)
    sel = G[selected]
    return host_trimmed_mean_of(sel, set_size - 2 * f - 1)
