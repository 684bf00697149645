"""Shared pieces of the observatory tests (tests/test_torch_port_telemetry.py,
_margins.py, _numerics.py): one configuration run by the port's engine on
the CPU and by the JAX engine on its XLA path from the same weights and
the same dataset (the pattern of tests/test_torch_port_round.py), and the
comparison of their event streams kind by kind, field by field.

Tolerances of :func:`compare_events`, each field against the JAX engine's:

- counts, flags, rounds, ids, actions and masks: equal;
- scores, selection margins, gaps, slacks and the colluder margin: within
  ``SCORE_TOL`` (1e-3) of the round's largest |score| (of |selection
  margin| when the run has no 'defense' event; Krum's scores are
  sums of distances; the port computes them from a Gram on the CPU, XLA
  from its own, and the two frameworks' gradients differ by about 1e-7
  relative, so a small margin, a difference of two large scores, carries
  that cancellation; measured below 5e-4);
- every other float: relative 1e-4 of the field's largest magnitude, plus
  1e-6 absolute (norms, cosines, kept fractions, boundary distances,
  log2 ranges: measured below 4e-6 relative, the rank-derived fractions
  of rows at a tie differ by one coordinate in d);
- ``kept_fraction`` of the unmasked TrimmedMean: NaN in the port (its
  kernel returns only the aggregate, as on the JAX package's Pallas
  route) where the XLA route reports it; the test holds
  ``margin_kept_frac`` to it instead;
- Bulyan's ``cancel_bits`` (``skip``): the cancellation depth of each
  engine's own distance matrix, which is what it measures: identical
  crafted rows come out a few ulp apart from one Gram and exactly 0 from
  another, so the smallest positive distance, and the bits, differ by
  design (tests/test_torch_port_numerics.py holds the function on one
  matrix).
"""

import json
import os

import jax
import numpy as np

from attacking_federate_learning_tpu import config as JC
from attacking_federate_learning_tpu.attacks import DriftAttack as JDrift
from attacking_federate_learning_tpu.config import (
    ExperimentConfig as JConfig, FaultConfig as JFaultConfig,
    TrafficConfig as JTrafficConfig
)
from attacking_federate_learning_tpu.core.engine import (
    FederatedExperiment as JExperiment
)
from attacking_federate_learning_tpu.data.datasets import (
    load_dataset as jax_load_dataset
)
from attacking_federate_learning_tpu.utils.metrics import (
    RunLogger as JRunLogger
)
from attacking_federate_learning_tpu_torch import config as C
from attacking_federate_learning_tpu_torch.attacks import DriftAttack
from attacking_federate_learning_tpu_torch.config import (
    ExperimentConfig, FaultConfig, TrafficConfig
)
from attacking_federate_learning_tpu_torch.core.engine import (
    FederatedExperiment
)
from attacking_federate_learning_tpu_torch.core.server import (
    init_server_state
)
from attacking_federate_learning_tpu_torch.data.datasets import load_dataset
from attacking_federate_learning_tpu_torch.utils.metrics import RunLogger
from attacking_federate_learning_tpu_torch.utils.weights import (
    from_jax_params
)

SIZES = dict(synth_train=1200, synth_test=300)
BASE = dict(dataset=C.SYNTH_MNIST_HARD, users_count=19, mal_prop=0.22,
            batch_size=32, epochs=2, test_step=1, **SIZES)
FLAGS = dict(telemetry=True, margins=True, numerics=True,
             log_round_stats=True)
SCORE_TOL = 1e-3
REL_TOL, ABS_TOL = 1e-4, 1e-6
# Fields compared as scores (tolerance on the round's score scale).
SCORE_FIELDS = ("scores", "margin_selection", "margin_gap", "margin_slack",
                "colluder_margin", "shard_scores", "shard_margin_selection",
                "shard_margin_gap", "shard_margin_slack",
                "shard_colluder_margin", "tier2_scores",
                "tier2_margin_selection", "tier2_margin_gap",
                "tier2_margin_slack", "tier2_colluder_margin")


def datasets():
    return (jax_load_dataset(JC.SYNTH_MNIST_HARD, seed=0, **SIZES),
            load_dataset(C.SYNTH_MNIST_HARD, seed=0, **SIZES))


def pair(ds, faults=None, traffic=None, attacker=None, jattacker=None,
         **kw):
    """The JAX engine (XLA route) and the port's engine (CPU) on the same
    configuration, dataset pair and initial weights."""
    cfg = {**BASE, **kw}
    jexp = JExperiment(
        JConfig(**cfg, aggregation_impl="xla",
                faults=faults and JFaultConfig(**faults),
                traffic=traffic and JTrafficConfig(**traffic)),
        attacker=jattacker or JDrift(1.5), dataset=ds[0])
    texp = FederatedExperiment(
        ExperimentConfig(**cfg, faults=faults and FaultConfig(**faults),
                         traffic=traffic and TrafficConfig(**traffic)),
        attacker or DriftAttack(1.5), ds[1], device="cpu")
    params = jax.tree.map(np.asarray, jexp.flat.unravel(jexp.state.weights))
    texp.state = init_server_state(from_jax_params(params))
    return jexp, texp


def run_events(jexp, texp, tmp_path):
    """Both runs to their end; their event streams (JAX's from its JSONL,
    the port's from a files-off RunLogger, each validated at record)."""
    with JRunLogger(jexp.cfg, None, str(tmp_path), jsonl_name="jax") as lg:
        jexp.run(lg)
    with open(os.path.join(tmp_path, "jax.jsonl")) as fh:
        jev = [json.loads(line) for line in fh]
    logger = RunLogger(texp.cfg, log_dir=None, log=lambda s: None)
    texp.run(logger)
    return jev, logger.events


def by_kind(events):
    out = {}
    for e in events:
        out.setdefault(e["kind"], []).append(e)
    return out


def _numbers(v):
    try:
        return np.asarray(v, np.float64)
    except (TypeError, ValueError):
        return None


def compare_events(jev, tev, kinds, nan_in_port=(), skip=()):
    """Every event of ``kinds``: the same count, keys and values within the
    tolerances of the module docstring.  ``nan_in_port`` names fields the
    port reports as NaN by design.  Returns the worst score and relative
    errors seen, for the caller to print or assert on."""
    J, T = by_kind(jev), by_kind(tev)
    # The score scale of a round: its largest finite |score| (or, with
    # margins alone, |selection margin|) in any of JAX's events.
    scale = {}
    for e in jev:
        for k in ("scores", "shard_scores", "tier2_scores",
                  "margin_selection", "shard_margin_selection",
                  "tier2_margin_selection"):
            if k in e and "round" in e:
                x = np.abs(np.asarray(e[k], np.float64))
                m = float(x[np.isfinite(x)].max(initial=0.0))
                scale[e["round"]] = max(scale.get(e["round"], 0.0), m)
    worst = {"score": 0.0, "rel": 0.0}
    for kind in kinds:
        js, ts = J.get(kind, []), T.get(kind, [])
        assert len(js) == len(ts) > 0, (kind, len(js), len(ts))
        for je, te in zip(js, ts):
            keys = set(je) - {"t", "v"}
            assert keys == set(te) - {"t", "v"}, (
                kind, sorted(keys ^ (set(te) - {"t", "v"})))
            sc = max(scale.get(je.get("round"), 0.0), 1e-30)
            for k in sorted(keys):
                a, b = je[k], te[k]
                if k in nan_in_port:
                    assert np.isnan(np.asarray(b, float)).all(), (kind, k)
                    continue
                if k in skip:
                    continue
                x, y = _numbers(a), _numbers(b)
                if x is None or x.dtype == object or isinstance(a, str):
                    assert a == b, (kind, k, a, b)
                    continue
                assert x.shape == y.shape, (kind, k, x.shape, y.shape)
                fin = np.isfinite(x) & np.isfinite(y)
                assert np.array_equal(x[~fin], y[~fin], equal_nan=True), (
                    kind, k)
                if not fin.any():
                    continue
                err = np.abs(x[fin] - y[fin])
                # A colluder margin is a score difference where the
                # defense selects, a boundary distance where it trims.
                tier = k[:-len("colluder_margin")]
                if k in SCORE_FIELDS and (
                        not k.endswith("colluder_margin")
                        or tier + "margin_selection" in je):
                    lim = SCORE_TOL * sc
                    worst["score"] = max(worst["score"],
                                         float(err.max()) / sc)
                else:
                    mag = float(np.abs(x[fin]).max())
                    lim = REL_TOL * mag + ABS_TOL
                    worst["rel"] = max(worst["rel"],
                                       float(err.max()) / max(mag, 1e-30))
                assert (err <= lim).all(), (kind, je.get("round"), k,
                                            float(err.max()), lim)
    return worst
