"""Coordinate-wise median defense (Yin et al., ICML'18), the JAX package's
``defenses/median.py``: the median along the client axis, robust to up
to half the clients per coordinate.

Without a mask it is the median kernel (jnp.median's midpoint of the two
middle values for an even count); with the quarantine ``mask`` the
masked-median kernel over the alive rows, and with ``weights`` (which
need ``mask``) their lower weighted median.
"""

from __future__ import annotations

from attacking_federate_learning_tpu_torch.defenses.kernels import (
    DEFENSES, check_weight_seam
)
from attacking_federate_learning_tpu_torch.ops.defense_kernels import (
    masked_median, median_of
)


def median(users_grads, users_count, corrupted_count, mask=None,
           weights=None):
    check_weight_seam(mask, weights)
    if mask is None:
        return median_of(users_grads)
    return masked_median(users_grads, mask, weights)


DEFENSES["Median"] = median
