"""Coordinate-wise median defense (Yin et al., ICML'18), the JAX package's
``defenses/median.py``: the median along the client axis, robust to up
to half the clients per coordinate.

Without a mask it is the median kernel (jnp.median's midpoint of the two
middle values for an even count); with the quarantine ``mask`` the
masked-median kernel over the alive rows, and with ``weights`` (which
need ``mask``) their lower weighted median.

``impl='host'`` is the native column-blocked kernel
(defenses/kernels.py:host_median_of), over the matrix copied to the host;
it has no mask seam and no ranks for margins, and refuses both with the
JAX package's messages.

Diagnostics (``telemetry=True``): ``dist_to_agg`` (n,), each client's L2
distance to the returned median; with ``margins``
``margin_kept_frac`` and ``margin_boundary_dist``
(utils/margins.py:median_pick_margins, rank ops beside the kernel); with
``numerics`` ``num_tie_rows``, banded at the input's largest finite
magnitude.
"""

from __future__ import annotations

import torch

from attacking_federate_learning_tpu_torch.defenses.kernels import (
    DEFENSES, check_impl, check_seams, host_median_of
)
from attacking_federate_learning_tpu_torch.ops.defense_kernels import (
    masked_median, median_of
)
from attacking_federate_learning_tpu_torch.utils.margins import (
    median_pick_margins
)
from attacking_federate_learning_tpu_torch.utils.numerics import (
    max_finite_abs, row_norms, tie_proximity
)


def median(users_grads, users_count, corrupted_count, mask=None,
           weights=None, impl="xla", telemetry=False, margins=False,
           numerics=False):
    check_seams(mask, weights, telemetry, margins, numerics)
    check_impl("impl", impl)
    if margins and impl == "host":
        raise ValueError(
            "Median margins need the on-device ranks; impl='host' "
            "returns only the aggregate (defenses/host.py)")
    if mask is not None and impl == "host":
        raise ValueError(
            "mask-aware Median has no host kernel "
            "(defenses/host.py is maskless); use impl='xla'")
    if mask is None:
        agg = (host_median_of(users_grads) if impl == "host"
               else median_of(users_grads))
    else:
        agg = masked_median(users_grads, mask, weights)
    if not telemetry:
        return agg
    diag = {"dist_to_agg": row_norms(users_grads.float()
                                     - agg.float()[None, :])}
    if margins:
        mf = median_pick_margins(users_grads, mask=mask, weights=weights)
        if numerics:
            key = (users_grads if mask is None else
                   torch.where(mask[:, None], users_grads, torch.inf))
            mf["num_tie_rows"] = tie_proximity(mf["margin_boundary_dist"],
                                               max_finite_abs(key))
        diag.update(mf)
    return agg, diag


DEFENSES["Median"] = median
