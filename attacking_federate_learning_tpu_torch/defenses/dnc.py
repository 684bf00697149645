"""DnC, the divide-and-conquer spectral defense (Shejwalkar & Houmansadr,
NDSS'21, the companion defense of the min-max/min-sum attacks), the JAX
package's ``defenses/dnc.py``.

Each of ``n_iters`` iterations subsamples a sketch of r coordinates,
centers the cohort there, takes the top right singular direction of the
centered sketch by 10 power steps from a random start, scores every
client by its squared projection and keeps the ``n - remove`` lowest
scores (``remove = min(int(filter_frac f), n - 1)``).  A client survives
only if every iteration kept it; the aggregate is the survivors' mean, or
the overall mean when none survives.  At r = d one iteration runs and no
sketch is drawn (every iteration would see the same matrix).

The draws are JAX's bit for bit: keys ``fold_in(fold_in(key(seed ^
0xD0C), round), i)`` split into ``(k_idx, k_pow)``, the sketch
``choice(k_idx, d, (r,), replace=False)``, which is the first r of
``permutation(k_idx, d)``, and the start ``normal(k_pow, (r,))``.  The
keys are split on the host (a few vectorized threefry calls); the bits,
the shuffle's sorts and the normal draw run on the gradients' device
(ops/threefry_bits.py: the threefry kernel on the card), all iterations'
sketches at once, and so do the iterations' power steps (one batched
product a step).  The start's ``erfinv`` is the device's, within a few
ulp of XLA's.

The keep set is ``lax.top_k(-scores, keep)`` there, which keeps the
lower index of equal scores (ALIE's identical rows score exactly alike):
here a stable ascending sort.  The engine passes the round index through
the ``needs_round`` seam (core/engine.py), so every round draws fresh
sketches.  Plain tensor code besides the draw, as it is plain XLA in the
JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from attacking_federate_learning_tpu_torch.defenses.kernels import DEFENSES
from attacking_federate_learning_tpu_torch.ops import threefry_bits as R
from attacking_federate_learning_tpu_torch.utils import threefry

_N_ITERS = 5
_FILTER_FRAC = 1.5
_SKETCH_DIM = 2048
_POWER_STEPS = 10


def sketch_keys(seed: int, round: int, n_iters: int) -> np.ndarray:
    """(n_iters, 2, 2) uint32: iteration i's ``(k_idx, k_pow)``, split
    from ``fold_in(base, i)`` (two vectorized threefry calls)."""
    base = threefry.fold_in(threefry.key(seed ^ 0xD0C), int(round))
    y0, y1 = threefry.threefry2x32(base, np.zeros(n_iters, np.uint32),
                                   np.arange(n_iters, dtype=np.uint32))
    return R.split_keys(np.stack([y0, y1], axis=1))


def draw_sketches(seed: int, round: int, n_iters: int, d: int, r: int,
                  device):
    """The round's draws on ``device``: ``(idx, v0)``, the (n_iters, r)
    int64 sketch coordinates (None at r == d) and the (n_iters, r) f32
    power-iteration starts."""
    keys = sketch_keys(seed, round, n_iters)
    idx = (None if r == d
           else R.permutations(keys[:, 0], d, device)[:, :r])
    return idx, R.normals(keys[:, 1], r, device)


def _top_direction(Sc, v):
    """Dominant right singular vector of each centered sketch ((..., n,
    r)) by power iteration on Sc^T Sc from ``v`` ((..., r))."""
    def unit(x):
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1,
                                                        keepdim=True),
                               min=1e-12)

    v = unit(v)
    for _ in range(_POWER_STEPS):
        v = unit((Sc.transpose(-2, -1) @ (Sc @ v[..., None]))[..., 0])
    return v


def scores(Sc: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., n) squared projections ``(Sc @ v) ** 2``, each row's dot
    product reduced alone, so that identical rows (ALIE's) score exactly
    alike: a matrix-vector product may sum rows in differing orders."""
    return ((Sc * v.unsqueeze(-2)).sum(-1)) ** 2


def iteration_scores(G: torch.Tensor, n_iters: int = _N_ITERS,
                     sketch_dim: int = _SKETCH_DIM, seed: int = 0,
                     round=0):
    """Every iteration's scores of the (n, d) f32 matrix ``G``, (I, n),
    all iterations batched (I = n_iters, or 1 at r = d), and the sketch
    coordinates (None at r = d)."""
    n, d = G.shape
    r = min(sketch_dim, d)
    if r == d:
        n_iters = 1
    idx, v0 = draw_sketches(seed, int(round), n_iters, d, r, G.device)
    if idx is None:
        S = G[None]
    else:
        S = G.index_select(1, idx.reshape(-1)).view(n, n_iters, r)
        S = S.transpose(0, 1)
    Sc = S - S.mean(1, keepdim=True)
    return scores(Sc, _top_direction(Sc, v0)), idx


def keep_sets(scores: torch.Tensor, keep: int) -> torch.Tensor:
    """(..., n) bool: in each row the ``keep`` lowest scores, the lower
    index first among equal ones (``lax.top_k(-scores, keep)``)."""
    idx = torch.sort(scores, dim=-1, stable=True).indices[..., :keep]
    good = torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    return good.scatter(-1, idx, True)


def survivor_mask(G: torch.Tensor, corrupted_count: int,
                  n_iters: int = _N_ITERS, filter_frac: float = _FILTER_FRAC,
                  sketch_dim: int = _SKETCH_DIM, seed: int = 0,
                  round=0) -> torch.Tensor:
    """(n,) bool: the clients no iteration marked as outliers, for the
    (n, d) f32 matrix ``G`` (the JAX function's telemetry
    ``survivor_mask``)."""
    n = G.shape[0]
    remove = min(int(filter_frac * corrupted_count), n - 1)
    if remove == 0:
        return torch.ones((n,), dtype=torch.bool, device=G.device)
    sc, _ = iteration_scores(G, n_iters, sketch_dim, seed, round)
    return keep_sets(sc, n - remove).all(0)


def dnc(users_grads, users_count, corrupted_count, n_iters: int = _N_ITERS,
        filter_frac: float = _FILTER_FRAC, sketch_dim: int = _SKETCH_DIM,
        seed: int = 0, round=0, telemetry=False):
    """``telemetry=True`` also returns ``survivor_mask`` (n,) f32 0/1 (the
    clients no iteration marked) and ``survivor_count`` () int32."""
    G = users_grads.float()
    n = G.shape[0]
    if min(int(filter_frac * corrupted_count), n - 1) == 0:
        if not telemetry:
            return G.mean(0)
        w = torch.ones(n, dtype=torch.float32, device=G.device)
        agg, survivors = G.mean(0), w.sum()
    else:
        w = survivor_mask(G, corrupted_count, n_iters, filter_frac,
                          sketch_dim, seed, round).float()
        survivors = w.sum()
        survivor_mean = (w @ G) / torch.clamp(survivors, min=1.0)
        # Empty intersection (possible at small n): the overall mean.
        agg = torch.where(survivors > 0, survivor_mean, G.mean(0))
    if not telemetry:
        return agg
    return agg, {"survivor_mask": w,
                 "survivor_count": survivors.to(torch.int32)}


# Engine seam: the round index, so that sketches refresh every round.
dnc.needs_round = True
DEFENSES["DnC"] = dnc
