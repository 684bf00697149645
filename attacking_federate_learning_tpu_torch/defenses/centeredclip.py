"""Centered-clipping robust aggregation (Karimireddy, He & Jaggi,
"Learning from History for Byzantine Robust Optimization", ICML 2021),
the JAX package's ``defenses/centeredclip.py``, stateless variant:

    v_0 = median(G);  v_{k+1} = v_k + mean_i(clip_tau(g_i - v_k))

``clip_tau`` rescales a row to L2 norm at most tau, so one Byzantine row
moves the estimate by at most tau / n a trip.  The anchor v_0 is the
coordinate-wise median, ``jnp.median(G, axis=0)`` there: here the median
kernel (ops/defense_kernels.py:median_of, csrc/median.cu on the card).
The trips are plain tensor code (row norms and a broadcast
multiply-add), as they are plain XLA in the JAX package.
"""

from __future__ import annotations

import torch

from attacking_federate_learning_tpu_torch.defenses.kernels import DEFENSES
from attacking_federate_learning_tpu_torch.ops.defense_kernels import (
    median_of
)


def clip_scale(norms, bound):
    """Each row's clip factor min(1, bound / ||row||) (1.0: inside the
    ball)."""
    return torch.clamp(bound / torch.clamp(norms, min=1e-12), max=1.0)


def centered_clip(users_grads, users_count, corrupted_count, tau=10.0,
                  iters=5, telemetry=False):
    """``telemetry=True`` also returns ``clip_scale`` (n,), each client's
    clip factor against the returned estimate, and ``clipped_count`` ()
    int32, the rows strictly clipped."""
    G = users_grads.float().contiguous()
    v = median_of(G)
    for _ in range(iters):
        diff = G - v[None, :]
        scale = clip_scale(torch.linalg.vector_norm(diff, dim=1), tau)
        v = v + (diff * scale[:, None]).mean(0)
    if not telemetry:
        return v
    scale = clip_scale(torch.linalg.vector_norm(G - v[None, :], dim=1), tau)
    return v, {"clip_scale": scale,
               "clipped_count": (scale < 1.0).sum().to(torch.int32)}


DEFENSES["CenteredClip"] = centered_clip
