"""Norm-bounding defense (Sun et al., "Can You Really Backdoor Federated
Learning?", 2019), the JAX package's ``defenses/normbound.py``: every
client update is clipped to the cohort's median L2 norm before
averaging, so a crafted gradient cannot out-weigh honest ones however it
is scaled.

The bound is ``jnp.median`` of the n row norms: the midpoint of the two
middle norms for an even n (``torch.median`` would return the lower
one), taken from a sort of the n norms.  No kernel: n values.
"""

from __future__ import annotations

import torch

from attacking_federate_learning_tpu_torch.defenses.kernels import DEFENSES


def norm_bounded_mean(users_grads, users_count, corrupted_count,
                      telemetry=False):
    """``telemetry=True`` also returns ``clip_scale`` (n,), ``clipped_count``
    () int32 (the clients the clip touched) and ``norm_bound`` () (the
    cohort-median bound)."""
    G = users_grads.float()
    norms = torch.linalg.vector_norm(G, dim=1)
    n = norms.shape[0]
    srt = torch.sort(norms).values
    bound = (srt[(n - 1) // 2] + srt[n // 2]) * 0.5
    scale = torch.clamp(bound / torch.clamp(norms, min=1e-12), max=1.0)
    agg = (G * scale[:, None]).mean(0)
    if not telemetry:
        return agg
    return agg, {"clip_scale": scale,
                 "clipped_count": (scale < 1.0).sum().to(torch.int32),
                 "norm_bound": bound}


DEFENSES["NormBound"] = norm_bounded_mean
