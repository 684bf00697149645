"""Partial participation: the port's cohort vs the JAX package's.

- ``threefry.permutation`` and ``choice(replace=False)`` must be
  ``jax.random``'s bit for bit, on sizes that take one shuffle round (up
  to 1,625) and two (past it, 10,000 among them).
- ``legacy_cohort`` must equal the JAX package's over a grid of (seed,
  round, n, f, participation).
- The config's and the engine's cohort messages are the JAX package's,
  word for word, and the defense guard judges the cohort.
- Whole runs at n = 20 with participation 0.6 (m = 12, m_mal = 2) on the
  CPU against the JAX ``FederatedExperiment`` on its XLA path: the same
  cohort ids every round, the same final weights (the tolerance of
  tests/test_torch_port_round.py), under Krum, TrimmedMean and Bulyan,
  and TrimmedMean once more with dropout faults, whose counts over the
  m cohort rows must equal the JAX engine's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attacking_federate_learning_tpu import config as JC
from attacking_federate_learning_tpu.attacks import DriftAttack as JDrift
from attacking_federate_learning_tpu.config import (
    ExperimentConfig as JConfig, FaultConfig as JFaultConfig
)
from attacking_federate_learning_tpu.core.engine import (
    FederatedExperiment as JExperiment
)
from attacking_federate_learning_tpu.core.population import (
    legacy_cohort as jax_legacy_cohort
)
from attacking_federate_learning_tpu.data.datasets import (
    load_dataset as jax_load_dataset
)
from attacking_federate_learning_tpu_torch import config as C
from attacking_federate_learning_tpu_torch.attacks import DriftAttack
from attacking_federate_learning_tpu_torch.config import (
    ExperimentConfig, FaultConfig
)
from attacking_federate_learning_tpu_torch.core.engine import (
    FederatedExperiment
)
from attacking_federate_learning_tpu_torch.core.population import (
    legacy_cohort
)
from attacking_federate_learning_tpu_torch.core.server import (
    init_server_state
)
from attacking_federate_learning_tpu_torch.data.datasets import load_dataset
from attacking_federate_learning_tpu_torch.utils import threefry
from attacking_federate_learning_tpu_torch.utils.weights import (
    from_jax_params
)

SIZES = dict(synth_train=1200, synth_test=300)
N, MAL_PROP, B, ROUNDS, P = 20, 0.2, 32, 3, 0.6


@pytest.fixture(scope="module")
def datasets():
    return (jax_load_dataset(JC.SYNTH_MNIST_HARD, seed=0, **SIZES),
            load_dataset(C.SYNTH_MNIST_HARD, seed=0, **SIZES))


# One shuffle round up to n = 1,625 (3 ln n <= ln(2**32 - 1)), two past.
@pytest.mark.parametrize("n", [1, 2, 5, 19, 100, 1625, 1626, 4000, 10000])
def test_permutation_matches_jax(n):
    rounds = int(np.ceil(3 * np.log(n) / np.log(2.0 ** 32 - 1)))
    assert rounds == (0 if n == 1 else 1 if n <= 1625 else 2)
    for seed in (0, 1, 7, 0x9A47, 2 ** 31 + 5):
        got = threefry.permutation(threefry.key(seed), n)
        want = np.asarray(jax.random.permutation(jax.random.key(seed), n))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,size", [(5, 0), (5, 3), (24, 14), (76, 46),
                                    (3000, 7), (10000, 6000)])
def test_choice_without_replacement_matches_jax(n, size):
    for seed in range(4):
        k = threefry.fold_in(threefry.key(seed), 3)
        jk = jax.random.fold_in(jax.random.key(seed), 3)
        np.testing.assert_array_equal(
            threefry.choice(k, n, size),
            np.asarray(jax.random.choice(jk, n, (size,), replace=False)))


def test_choice_refuses_what_it_does_not_port():
    with pytest.raises(NotImplementedError):
        threefry.choice(threefry.key(0), 5, 2, replace=True)
    with pytest.raises(ValueError, match="larger sample"):
        threefry.choice(threefry.key(0), 3, 4)


@pytest.mark.parametrize("seed", [0, 1, 42])
def test_legacy_cohort_matches_jax(seed):
    pk = threefry.key(seed ^ 0x9A47)
    jpk = jax.random.key(seed ^ 0x9A47)
    for n, f, p in ((20, 4, 0.6), (100, 24, 0.6), (100, 10, 0.3),
                    (19, 0, 0.5), (3000, 720, 0.5), (10, 2, 0.1)):
        m = max(1, int(round(p * n)))
        m_mal = min(int(round(p * f)), m)
        for t in (0, 1, 2, 17, 299):
            got = legacy_cohort(pk, t, n, f, m, m_mal)
            want = np.asarray(jax_legacy_cohort(jpk, jnp.int32(t), n, f, m,
                                                m_mal))
            np.testing.assert_array_equal(got, want)
            assert (got[:m_mal] < f).all() and (got[m_mal:] >= f).all()
            assert len(set(got.tolist())) == m


@pytest.mark.parametrize("kw", [dict(participation=0.0),
                                dict(participation=1.5),
                                dict(participation=-0.1),
                                dict(local_steps=0),
                                dict(krum_scoring_method="heap"),
                                dict(distance_dtype="float16"),
                                dict(bulyan_batch_select=0)])
def test_config_messages_are_the_jax_packages(kw):
    with pytest.raises(ValueError) as je:
        JConfig(**kw)
    with pytest.raises(ValueError) as te:
        ExperimentConfig(**kw)
    assert str(te.value) == str(je.value)


def test_config_fields_have_the_jax_defaults():
    j, t = JConfig(), ExperimentConfig()
    for name in ("participation", "local_steps", "server_uses_faded_lr",
                 "grad_dtype", "distance_dtype", "krum_scoring_method",
                 "bulyan_batch_select", "partition", "style_strength",
                 "collect_metadata", "metadata_fraction"):
        assert getattr(t, name) == getattr(j, name), name
    with pytest.raises(ValueError, match="grad_dtype"):
        ExperimentConfig(grad_dtype="float16")
    assert ExperimentConfig(partition="femnist_style").partition == (
        "femnist_style")


# The malicious cohort rounds to 0 while f > 0.  (The engines' other
# cohort check, too few honest clients, cannot fire: m - m_mal > n - f
# needs n - m < f - m_mal, and round() keeps n - m near n (1 - p) >= f (1
# - p) near f - m_mal, for every n < 40 and p in steps of 0.01.)
@pytest.mark.parametrize("n,mal_prop,p", [(20, 0.1, 0.2), (3, 0.34, 0.5),
                                          (100, 0.01, 0.3)])
def test_cohort_messages_are_the_jax_engines(n, mal_prop, p, datasets):
    kw = dict(dataset=C.SYNTH_MNIST_HARD, users_count=n, mal_prop=mal_prop,
              participation=p, **SIZES)
    with pytest.raises(ValueError) as je:
        JExperiment(JConfig(**kw), dataset=datasets[0])
    with pytest.raises(ValueError) as te:
        FederatedExperiment(ExperimentConfig(**kw), dataset=datasets[1],
                            device="cpu")
    assert str(te.value) == str(je.value)


def test_guard_checks_cohort_not_population(datasets):
    """The JAX package's test of the same name: Bulyan needs m >= 4 m_mal
    + 3.  n = 22, f = 5 fails at full participation (22 < 23), but the p =
    0.5 cohort (m = 11, m_mal = 2) passes and trains."""
    kw = dict(dataset=C.SYNTH_MNIST_HARD, users_count=22, mal_prop=0.23,
              defense="Bulyan", batch_size=B, **SIZES)
    with pytest.raises(ValueError, match="Bulyan"):
        FederatedExperiment(ExperimentConfig(**kw), dataset=datasets[1],
                            device="cpu")
    exp = FederatedExperiment(ExperimentConfig(participation=0.5, **kw),
                              DriftAttack(1.5), datasets[1], device="cpu")
    assert (exp.m, exp.m_mal) == (11, 2)
    exp.run_round(0)
    assert exp.state.round == 1


def test_stragglers_are_refused_under_participation(datasets):
    kw = dict(dataset=C.SYNTH_MNIST_HARD, users_count=N, mal_prop=MAL_PROP,
              defense="TrimmedMean", participation=P, **SIZES)
    with pytest.raises(ValueError) as je:
        JExperiment(JConfig(**kw, faults=JFaultConfig(straggler=0.1)),
                    dataset=datasets[0])
    with pytest.raises(ValueError) as te:
        FederatedExperiment(ExperimentConfig(
            **kw, faults=FaultConfig(straggler=0.1)), dataset=datasets[1],
            device="cpu")
    assert str(te.value) == str(je.value)
    assert "straggler faults need participation=1.0" in str(te.value)


@pytest.mark.parametrize("partition", ["iid", "femnist_style"])
@pytest.mark.parametrize("participation", [1.0, P])
def test_a_given_cohort_is_the_drawn_one(participation, partition,
                                         datasets):
    """run_round draws the cohort before deliver and hands it over;
    deliver given the cohort, as host ids or their device copy, is
    deliver drawing it, bit for bit."""
    exp = FederatedExperiment(ExperimentConfig(
        dataset=C.SYNTH_MNIST_HARD, users_count=N, mal_prop=MAL_PROP,
        batch_size=B, participation=participation, partition=partition,
        **SIZES), dataset=datasets[1], device="cpu")
    for t in (0, 2):
        part = exp.participants(t)
        assert (part is None) == (participation == 1.0)
        drawn = exp.compute_grads(t)
        assert drawn.shape == (exp.m, exp.flat.dim)
        assert torch.equal(exp.compute_grads(t, part), drawn)
        if part is not None:
            ids = torch.from_numpy(part).to(torch.int64)
            for got, want in zip(exp.gather_batches(t, ids),
                                 exp.gather_batches(t, part)):
                assert torch.equal(got, want)
            xs = exp.gather_batches(t, part)[0]
            assert torch.equal(exp.apply_style(xs, ids),
                               exp.apply_style(xs, part))


_RUNS = [("Krum", None), ("TrimmedMean", None), ("Bulyan", None),
         ("TrimmedMean", dict(dropout=0.15, corrupt=0.1))]


@pytest.mark.parametrize("defense,faults", _RUNS,
                         ids=["Krum", "TrimmedMean", "Bulyan",
                              "TrimmedMean-faulted"])
def test_three_rounds_under_participation_match_the_jax_engine(
        defense, faults, datasets):
    kw = dict(dataset=C.SYNTH_MNIST_HARD, users_count=N, mal_prop=MAL_PROP,
              batch_size=B, epochs=ROUNDS, defense=defense, participation=P,
              **SIZES)
    jexp = JExperiment(JConfig(**kw, aggregation_impl="xla",
                               telemetry=faults is not None,
                               faults=faults and JFaultConfig(**faults)),
                       attacker=JDrift(1.5), dataset=datasets[0])
    texp = FederatedExperiment(
        ExperimentConfig(**kw, faults=faults and FaultConfig(**faults)),
        DriftAttack(1.5), datasets[1], device="cpu")
    assert (texp.m, texp.m_mal) == (jexp.m, jexp.m_mal) == (12, 2)
    params = jax.tree.map(np.asarray, jexp.flat.unravel(jexp.state.weights))
    texp.state = init_server_state(from_jax_params(params))
    for t in range(ROUNDS):
        np.testing.assert_array_equal(
            texp.participants(t),
            np.asarray(jexp._participants(jnp.int32(t))))
        jexp.run_round(t)
        texp.run_round(t)
        if faults:
            want = {k[len("fault_"):]: int(v) for k, v in
                    jexp.last_round_telemetry.items()
                    if k.startswith("fault_")}
            got = {k: int(v) for k, v in texp.last_round_faults.items()
                   if k != "round"}
            assert got == want
    # Same inputs and fp32 arithmetic in other summation orders: three
    # momentum steps keep the weights far below 1e-5 apart (measured
    # ~5e-8), as in tests/test_torch_port_round.py.
    np.testing.assert_allclose(texp.state.weights.numpy(),
                               np.asarray(jexp.state.weights), rtol=0,
                               atol=1e-5)
