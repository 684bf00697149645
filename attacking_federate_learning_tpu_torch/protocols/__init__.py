"""Simulated wire protocols between clients and the server: the JAX
package's :mod:`secagg`, pairwise-masked secure aggregation (Bonawitz et
al., arXiv 1611.04482) with bit-exact mask cancellation
(core/engine.py ``cfg.secagg``)."""

from attacking_federate_learning_tpu_torch.protocols.secagg import (  # noqa: F401
    SECAGG_MODES, secagg_cohort, secagg_key
)
