"""Geometric-median aggregation (RFA: Pillutla, Kakade, Harchaoui, IEEE
TSP 2022) by the smoothed Weiszfeld iteration, the JAX package's
``defenses/geomed.py``:

    w_i = 1 / max(eps, ||z - g_i||);  z <- sum_i w_i g_i / sum_i w_i

from the mean, ``iters`` times.  The distances are norms of the
differences G - z, as in the JAX package: the expansion ||g||^2 - 2 g.z
+ ||z||^2 cancels near the median, where the weights matter most.
Plain tensor code (row norms and one vector-matrix product a step), as it
is plain XLA in the JAX package.
"""

from __future__ import annotations

import torch

from attacking_federate_learning_tpu_torch.defenses.kernels import DEFENSES

_ITERS = 10
_EPS = 1e-6


def geometric_median(users_grads, users_count, corrupted_count,
                     iters: int = _ITERS, eps: float = _EPS,
                     telemetry=False):
    """``telemetry=True`` also returns ``dist_to_agg`` (n,), each client's
    distance to the geometric median (the Weiszfeld weights are 1 /
    dist)."""
    G = users_grads.float()
    z = G.mean(0)
    for _ in range(iters):
        dist = torch.linalg.vector_norm(G - z[None, :], dim=1)
        w = 1.0 / torch.clamp(dist, min=eps)
        z = (w @ G) / w.sum()
    if not telemetry:
        return z
    return z, {"dist_to_agg": torch.linalg.vector_norm(G - z[None, :],
                                                       dim=1)}


DEFENSES["GeoMedian"] = geometric_median
