"""The whole slice: the port's flat FedSGD round vs the JAX engine.

For each of the reference's four defenses under ALIE (n = 19, f = 4,
B = 32, SYNTH_MNIST_HARD at a small size), both engines start from the
same weights (the JAX init, carried over as numpy) and run three rounds:
the port on the CPU, where its kernel wrappers take their plain versions,
and the JAX ``FederatedExperiment`` on the XLA path
(``aggregation_impl='xla'``).  Final weights must agree, the Krum winner
must be the same client every round, and evaluation must agree.
"""

import jax
import numpy as np
import pytest

from attacking_federate_learning_tpu import config as JC
from attacking_federate_learning_tpu.attacks import DriftAttack as JDrift
from attacking_federate_learning_tpu.config import (
    ExperimentConfig as JConfig
)
from attacking_federate_learning_tpu.core.engine import (
    FederatedExperiment as JExperiment
)
from attacking_federate_learning_tpu.data.datasets import (
    load_dataset as jax_load_dataset
)
from attacking_federate_learning_tpu_torch import config as C
from attacking_federate_learning_tpu_torch.attacks import DriftAttack, paper_z
from attacking_federate_learning_tpu_torch.config import ExperimentConfig
from attacking_federate_learning_tpu_torch.core.engine import (
    FederatedExperiment
)
from attacking_federate_learning_tpu_torch.core.server import (
    init_server_state
)
from attacking_federate_learning_tpu_torch.data.datasets import load_dataset
from attacking_federate_learning_tpu_torch.utils.weights import (
    from_jax_params
)

N, MAL_PROP, B, ROUNDS = 19, 0.22, 32, 3
SIZES = dict(synth_train=1200, synth_test=300)


@pytest.fixture(scope="module")
def datasets():
    return (jax_load_dataset(JC.SYNTH_MNIST_HARD, seed=0, **SIZES),
            load_dataset(C.SYNTH_MNIST_HARD, seed=0, **SIZES))


def _pair(defense, datasets):
    kw = dict(dataset=C.SYNTH_MNIST_HARD, users_count=N, mal_prop=MAL_PROP,
              batch_size=B, epochs=ROUNDS, defense=defense, **SIZES)
    jexp = JExperiment(JConfig(**kw, aggregation_impl="xla",
                               log_round_stats=True),
                       attacker=JDrift(1.5), dataset=datasets[0])
    texp = FederatedExperiment(ExperimentConfig(**kw), DriftAttack(1.5),
                               datasets[1], device="cpu")
    params = jax.tree.map(np.asarray, jexp.flat.unravel(jexp.state.weights))
    texp.state = init_server_state(from_jax_params(params))
    return jexp, texp


@pytest.mark.parametrize("defense", C.DEFENSE_NAMES)
def test_three_rounds_match_the_jax_engine(defense, datasets):
    jexp, texp = _pair(defense, datasets)
    assert texp.f == jexp.f == 4
    winners = []
    if defense == "Krum":
        inner = texp.defense_fn

        def spy(grads, n, f):
            out = inner(grads, n, f)
            rows = np.flatnonzero((grads == out).all(1).numpy())
            winners.append(rows)
            return out

        texp.defense_fn = spy
    for t in range(ROUNDS):
        jexp.run_round(t)
        texp.run_round(t)
        if defense == "Krum":
            # The JAX winner is one of the rows equal to the port's
            # aggregate (ALIE's crafted rows are identical copies).
            won = int(jexp.last_round_stats["krum_selected"])
            assert won in winners[t]
    want = np.asarray(jexp.state.weights)
    got = texp.state.weights.numpy()
    # Same inputs and the same arithmetic in fp32; the two frameworks sum
    # in other orders, which three momentum steps at lr 0.1 keep far below
    # 1e-5 per weight (measured ~1e-7 here).
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(texp.state.velocity.numpy(),
                               np.asarray(jexp.state.velocity), atol=1e-5)
    jl, jc = jexp.evaluate(jexp.state.weights)
    tl, tc = texp.evaluate(texp.state.weights)
    assert int(jc) == int(tc)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


def test_run_prints_the_reference_eval_lines(datasets):
    cfg = ExperimentConfig(dataset=C.SYNTH_MNIST_HARD, users_count=N,
                           mal_prop=MAL_PROP, batch_size=B, epochs=3,
                           test_step=2, defense="TrimmedMean", **SIZES)
    lines = []
    result = FederatedExperiment(cfg, DriftAttack(1.5), datasets[1],
                                 device="cpu").run(log=lines.append)
    assert result["epochs"] == [0, 2]
    evals = [s for s in lines if s.startswith("Test set: [")]
    assert len(evals) == 2 and evals[0].startswith("Test set: [  0]")
    assert evals[1].endswith("({:.2f}%)".format(result["accuracies"][1]))
    assert "/300 (" in evals[0]
    assert lines[-1].startswith("Max accuracy: ")


def test_config_matches_the_jax_config():
    for n, m in ((10, 0.24), (100, 0.24), (19, 0.21), (7, 0.3)):
        a = JConfig(users_count=n, mal_prop=m, num_std="auto")
        b = ExperimentConfig(users_count=n, mal_prop=m, num_std="auto")
        assert a.corrupted_count == b.corrupted_count
        assert a.num_std == b.num_std == paper_z(n, b.corrupted_count)
        assert a.fading_rate == b.fading_rate and b.model == "mnist_mlp"
    for bad in (True, "x", None):
        with pytest.raises(ValueError) as je:
            JConfig(num_std=bad)
        with pytest.raises(ValueError) as te:
            ExperimentConfig(num_std=bad)
        assert str(je.value) == str(te.value)
