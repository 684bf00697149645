"""'A Little Is Enough' (ALIE) mean-shift drift attack.

Reference ``DriftAttack`` (malicious.py:30-36): the crafted gradient is the
malicious cohort's mean shifted down by z standard deviations per
coordinate, ``mean - z * sigma``.  z is the fixed CLI constant num_std
(default 1.5, reference main.py:109-110); ``num_std='auto'``
(beyond-reference) computes the paper's z_max via :func:`paper_z`.
"""

from __future__ import annotations

from statistics import NormalDist

import torch

from attacking_federate_learning_tpu_torch.attacks.base import (
    Attack, delivered_cohort_stats, wire_scalar
)
from attacking_federate_learning_tpu_torch.utils.numerics import row_norms


def paper_z(users_count: int, corrupted_count: int) -> float:
    """The ALIE paper's z_max (Baruch et al., NeurIPS'19 §3.1).  With
    ``s = floor(n/2 + 1) - f`` honest supporters required,

        z_max = Phi^-1((n - f - s) / (n - f)),

    clamped to [0, z(0.9999)]: p <= 0.5 grants no positive hiding room
    (z = 0), and an attacker majority drives p past 1, where z_max is
    unbounded, so it caps at the 0.9999 quantile."""
    n, f = int(users_count), int(corrupted_count)
    honest = n - f
    if honest <= 0:
        return 0.0
    s = n // 2 + 1 - f
    p = (honest - s) / honest
    if p <= 0.5:
        return 0.0
    return float(NormalDist().inv_cdf(min(p, 0.9999)))


class DriftAttack(Attack):
    name = "alie"
    # Coordinate-wise: over the mesh's model axis each position crafts its
    # own columns (core/engine.py:_craft).
    columnwise = True

    def craft(self, mal_grads, ctx=None):
        # Async rounds: the statistics of the delivered malicious rows,
        # the envelope the server actually aggregates.
        mean, stdev = delivered_cohort_stats(mal_grads, ctx)
        return mean - wire_scalar(self.num_std, stdev) * stdev

    def envelope_stats(self, users_grads, corrupted_count, ctx=None):
        """The z-bound envelope: the cohort mean's and sigma's norms and
        the drift ||z sigma||, the crafted vector's distance from the
        honest mean."""
        f = corrupted_count
        if f == 0 or self.num_std == 0:
            return {}
        mean, stdev = delivered_cohort_stats(users_grads[:f], ctx)
        z = torch.tensor(float(self.num_std), dtype=torch.float32,
                         device=users_grads.device)
        sigma_norm = row_norms(stdev)
        return {"z": z, "mean_norm": row_norms(mean),
                "sigma_norm": sigma_norm, "drift_norm": z * sigma_norm}

    def margin_stats(self, users_grads, corrupted_count, ctx=None,
                     crafted=None):
        """Envelope utilization: the z the attack spends against the
        paper's z_max for this cohort (``z_utilization`` < 1: hiding room
        left; > 1: beyond the paper's majority argument; inf when z_max is
        0), and the drift in envelope units."""
        f = corrupted_count
        if f == 0 or self.num_std == 0:
            return {}
        z = float(self.num_std)
        z_max = paper_z(users_grads.shape[0], f)
        util = z / z_max if z_max > 0 else float("inf")
        _, stdev = delivered_cohort_stats(users_grads[:f], ctx)

        def f32(x):
            return torch.tensor(x, dtype=torch.float32,
                                device=users_grads.device)

        return {"z_used": f32(z), "z_max": f32(z_max),
                "z_utilization": f32(util),
                "drift_norm": f32(z) * row_norms(stdev)}
