"""The per-round participation cohort.

Only the JAX package's ``core/population.py:legacy_cohort`` is ported: the
``--participation`` draw of the flat round, bit for bit (the threefry
draws on the host, utils/threefry.py).  The population registry and the
traffic engine of that module are a later slice of the port.
"""

from __future__ import annotations

import numpy as np

from attacking_federate_learning_tpu_torch.utils import threefry


def legacy_cohort(part_key: np.ndarray, t: int, n: int, f: int, m: int,
                  m_mal: int) -> np.ndarray:
    """Round-t cohort ids, (m,) int32: the first m_mal are malicious ids
    (< f), the rest honest (>= f) — random identities, static counts.
    ``part_key`` is ``threefry.key(seed ^ 0x9A47)``."""
    k1, k2 = threefry.split(threefry.fold_in(part_key, t))
    mal = threefry.choice(k1, f, m_mal)
    hon = f + threefry.choice(k2, n - f, m - m_mal)
    return np.concatenate([mal, hon]).astype(np.int32)
