"""NumPy oracles of the defenses, the JAX package's
``defenses/oracle.py``: independent array-based re-derivations of the
reference semantics (reference defences.py:13-70: n - f Krum scoring,
the median-anchored trim, shrinking-pool Bulyan), simple and loop-based
so that a bug here is unlikely to coincide with one in the defenses.
Run in float64 they are the referee of utils/numerics.py:adjudicate.
"""

from __future__ import annotations

import numpy as np


def np_pairwise_distances(G):
    diffs = G[:, None, :] - G[None, :, :]
    return np.linalg.norm(diffs, axis=-1)


def np_no_defense(G, users_count, corrupted_count):
    return np.mean(G, axis=0)


def np_krum_select(G, users_count, corrupted_count, alive=None, D=None):
    """Index of the Krum winner among the alive users."""
    n = G.shape[0]
    if D is None:
        D = np_pairwise_distances(G)
    if alive is None:
        alive = np.ones(n, bool)
    k = users_count - corrupted_count
    best_idx, best_err = -1, np.inf
    for i in range(n):
        if not alive[i]:
            continue
        others = [D[i, j] for j in range(n) if j != i and alive[j]]
        err = float(np.sum(np.sort(others)[:k]))
        if err < best_err:
            best_err, best_idx = err, i
    return best_idx


def np_krum(G, users_count, corrupted_count):
    return G[np_krum_select(G, users_count, corrupted_count)]


def np_trimmed_mean(G, users_count, corrupted_count):
    keep = G.shape[0] - corrupted_count - 1
    med = np.median(G, axis=0)
    dev = G - med
    order = np.argsort(np.abs(dev), axis=0, kind="stable")
    kept = np.take_along_axis(dev, order[:keep], axis=0)
    return np.mean(kept, axis=0) + med


def np_bulyan(G, users_count, corrupted_count):
    n = G.shape[0]
    f = corrupted_count
    set_size = users_count - 2 * f
    D = np_pairwise_distances(G)
    alive = np.ones(n, bool)
    selected = []
    while len(selected) < set_size:
        idx = np_krum_select(G, users_count - len(selected), f,
                             alive=alive, D=D)
        selected.append(idx)
        alive[idx] = False
    return np_trimmed_mean(G[selected], set_size, 2 * f)


NP_DEFENSES = {
    "NoDefense": np_no_defense,
    "Krum": np_krum,
    "TrimmedMean": np_trimmed_mean,
    "Bulyan": np_bulyan,
}
