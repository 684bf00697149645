"""The whole slice: the port's flat FedSGD round vs the JAX engine.

For each defense under ALIE (n = 19, f = 4, B = 32, SYNTH_MNIST_HARD at
a small size), both engines start from the same weights (the JAX init,
carried over as numpy) and run three rounds: the port on the CPU, where
its kernel wrappers take their plain versions, and the JAX
``FederatedExperiment`` on the XLA path (``aggregation_impl='xla'``).
Final weights must agree, the Krum winner must be the same client every
round, and evaluation must agree.  The faulted cases add
``FaultConfig(dropout=0.15, straggler=0.15, straggler_delay=1,
corrupt=0.1)``: both engines draw the same schedule, so the per-round
fault counts must be equal too.  The watchdog case runs a diverging
NoDefense experiment through ``run()``.
"""

import jax
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
from attacking_federate_learning_tpu.data.datasets import (
    load_dataset as jax_load_dataset
)
from attacking_federate_learning_tpu_torch import config as C
from attacking_federate_learning_tpu_torch.attacks import DriftAttack, paper_z
from attacking_federate_learning_tpu_torch.config import (
    ExperimentConfig, FaultConfig
)
from attacking_federate_learning_tpu_torch.core.faults import (
    MASK_AWARE_DEFENSES
)
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
FAULTS = dict(dropout=0.15, straggler=0.15, straggler_delay=1, corrupt=0.1)


@pytest.fixture(scope="module")
def datasets():
    return (jax_load_dataset(JC.SYNTH_MNIST_HARD, seed=0, **SIZES),
            load_dataset(C.SYNTH_MNIST_HARD, seed=0, **SIZES))


def _pair(defense, datasets, faults=None, mal_prop=MAL_PROP):
    kw = dict(dataset=C.SYNTH_MNIST_HARD, users_count=N, mal_prop=mal_prop,
              batch_size=B, epochs=ROUNDS, defense=defense, **SIZES)
    # With faults the JAX engine reports the Krum winner only through its
    # defense telemetry (the same aggregate, plus the selection mask).
    jexp = JExperiment(JConfig(**kw, aggregation_impl="xla",
                               log_round_stats=True,
                               telemetry=faults is not None,
                               faults=faults and JFaultConfig(**faults)),
                       attacker=JDrift(1.5), dataset=datasets[0])
    texp = FederatedExperiment(
        ExperimentConfig(**kw, faults=faults and FaultConfig(**faults)),
        DriftAttack(1.5), datasets[1], device="cpu")
    params = jax.tree.map(np.asarray, jexp.flat.unravel(jexp.state.weights))
    texp.state = init_server_state(from_jax_params(params))
    return jexp, texp


# (defense, faults, mal_prop).  Faulted Bulyan runs at f = 1: at f = 4 its
# masked tail keeps max(e - 2f - 2f - 1, 1) = 1 value of the first e - 8
# alive picks, and when that count is even the two middle values tie
# about their midpoint, so gradient noise far below the tolerance (the
# two frameworks' backward passes differ by ~1e-7) decides which one is
# kept and the aggregates part by the gap between them.  At f = 1 the
# tail keeps about ten values.
# Clean Krum also runs at mal_prop 0 (f = 0), where the complement
# c = f - 1 is negative and the scores come from the exact sort.
# The five mask-aware defenses (the beyond-reference five are held in
# tests/test_torch_port_extensions.py).
_CASES = ([(d, None, MAL_PROP) for d in MASK_AWARE_DEFENSES]
          + [(d, FAULTS, MAL_PROP) for d in MASK_AWARE_DEFENSES
             if d != "Bulyan"] + [("Bulyan", FAULTS, 0.06)]
          + [("Krum", None, 0.0)])


@pytest.mark.parametrize(
    "defense,faults,mal_prop", _CASES,
    ids=[(f"{d}-faulted" if fl else d) + ("-f0" if m == 0 else "")
         for d, fl, m in _CASES])
def test_three_rounds_match_the_jax_engine(defense, faults, mal_prop,
                                           datasets):
    jexp, texp = _pair(defense, datasets, faults, mal_prop)
    assert texp.f == jexp.f == int(mal_prop * N)
    winners = []
    if defense == "Krum":
        inner = texp.defense_fn

        def spy(grads, n, f, **kw):
            out = inner(grads, n, f, **kw)
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
        if faults:
            want = {k[len("fault_"):]: int(v) for k, v in
                    jexp.last_round_telemetry.items()
                    if k.startswith("fault_")}
            got = {k: int(v) for k, v in texp.last_round_faults.items()
                   if k != "round"}
            assert got == want and texp.last_round_faults["round"] == t
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
    # The run lifecycle's fields: JAX's defaults, JAX's csv_name and
    # JAX's refusal of a negative checkpoint_every.
    a, b = JConfig(), ExperimentConfig()
    for name in ("checkpoint_every", "checkpoint_acc_threshold", "output",
                 "log_dir", "run_dir", "test_step", "data_dir"):
        assert getattr(a, name) == getattr(b, name), name
    assert (b.checkpoint_acc_threshold, b.log_dir, b.run_dir,
            b.output) == (70.0, "logs", "runs", None)
    kw = dict(dataset=C.SYNTH_CIFAR10, defense="Krum", backdoor="pattern",
              users_count=100, mal_prop=0.24, checkpoint_every=5)
    assert JConfig(**kw).csv_name() == ExperimentConfig(**kw).csv_name()
    with pytest.raises(ValueError) as je:
        JConfig(checkpoint_every=-3)
    with pytest.raises(ValueError) as te:
        ExperimentConfig(checkpoint_every=-3)
    assert str(je.value) == str(te.value)


# Paper scoring: Krum sums the n - f - 2 closest distances.  Krum runs the
# fused kernel's plain version (unmasked) and, faulted, the masked sort;
# Bulyan its selection loop.  Bulyan needs n >= 4f + 3: f = 4 of 19.
_PAPER = [("Krum", None), ("Krum", FAULTS), ("Bulyan", None)]


@pytest.mark.parametrize("defense,faults", _PAPER,
                         ids=["Krum", "Krum-faulted", "Bulyan"])
def test_paper_scoring_rounds_match_the_jax_engine(defense, faults,
                                                   datasets):
    """krum_paper_scoring (--krum-paper-scoring) through whole rounds:
    three rounds of both engines from the same weights, as
    test_three_rounds_match_the_jax_engine, with the winner of each
    Krum round checked against the JAX engine's."""
    kw = dict(dataset=C.SYNTH_MNIST_HARD, users_count=N, mal_prop=MAL_PROP,
              batch_size=B, epochs=ROUNDS, defense=defense,
              krum_paper_scoring=True, **SIZES)
    jexp = JExperiment(JConfig(**kw, aggregation_impl="xla",
                               log_round_stats=True,
                               telemetry=faults is not None,
                               faults=faults and JFaultConfig(**faults)),
                       attacker=JDrift(1.5), dataset=datasets[0])
    texp = FederatedExperiment(
        ExperimentConfig(**kw, faults=faults and FaultConfig(**faults)),
        DriftAttack(1.5), datasets[1], device="cpu")
    params = jax.tree.map(np.asarray, jexp.flat.unravel(jexp.state.weights))
    texp.state = init_server_state(from_jax_params(params))
    assert texp.defense_fn.keywords["paper_scoring"] is True
    winners = []
    if defense == "Krum":
        inner = texp.defense_fn

        def spy(grads, n, f, **kw):
            out = inner(grads, n, f, **kw)
            winners.append(np.flatnonzero((grads == out).all(1).numpy()))
            return out

        texp.defense_fn = spy
    for t in range(ROUNDS):
        jexp.run_round(t)
        texp.run_round(t)
        if defense == "Krum" and faults is None:
            assert int(jexp.last_round_stats["krum_selected"]) in winners[t]
    np.testing.assert_allclose(texp.state.weights.numpy(),
                               np.asarray(jexp.state.weights), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(texp.state.velocity.numpy(),
                               np.asarray(jexp.state.velocity), atol=1e-5)


def test_watchdog_rolls_back_then_raises(datasets):
    """The JAX engine's test_watchdog_rollback_then_abort without a
    checkpointer: finite bit-scaled corruption under NoDefense explodes
    the weight norm; the watchdog rolls back to the state at the start
    of run() and, past max_rollbacks, raises FloatingPointError with the
    state restored and finite.  The JAX engine, given the same config,
    does the same."""
    fc = dict(corrupt=0.3, corrupt_mode="scale", corrupt_scale=1e30,
              watchdog_norm=1e6, max_rollbacks=1)
    kw = dict(dataset=C.SYNTH_MNIST_HARD, users_count=10, mal_prop=0.0,
              batch_size=B, epochs=10, test_step=5, defense="NoDefense",
              **SIZES)
    texp = FederatedExperiment(
        ExperimentConfig(**kw, faults=FaultConfig(**fc)), DriftAttack(0.0),
        datasets[1], device="cpu")
    w0 = texp.state.weights.clone()
    lines = []
    with pytest.raises(FloatingPointError, match="diverged") as te:
        texp.run(log=lines.append)
    rollbacks = [s for s in lines if s.startswith("!! server state")]
    # max_rollbacks=1: one rollback and retry, then the aborting one; the
    # deterministic retry diverges at the same round.
    assert len(rollbacks) == 2 and rollbacks[0] == rollbacks[1].replace(
        "rollback 2/1", "rollback 1/1")
    assert texp.state.round == 0 and torch.equal(texp.state.weights, w0)
    assert bool(torch.isfinite(texp.state.weights).all())

    jexp = JExperiment(JConfig(**kw, faults=JFaultConfig(**fc)),
                       attacker=JDrift(0.0), dataset=datasets[0])
    with pytest.raises(FloatingPointError) as je:
        jexp.run()
    assert str(te.value) == str(je.value)


def test_faulted_run_reports_counts_at_the_eval_rounds(datasets):
    """run() returns one row of counts per round, equal to a host replay
    of the schedule, and evaluates on the usual cadence."""
    from attacking_federate_learning_tpu_torch.core.faults import (
        fault_masks
    )

    cfg = ExperimentConfig(dataset=C.SYNTH_MNIST_HARD, users_count=N,
                           mal_prop=MAL_PROP, batch_size=B, epochs=4,
                           test_step=2, defense="Median",
                           faults=FaultConfig(**FAULTS), **SIZES)
    exp = FederatedExperiment(cfg, DriftAttack(1.5), datasets[1],
                              device="cpu")
    result = exp.run(log=lambda s: None)
    assert result["epochs"] == [0, 2, 3]
    assert [r["round"] for r in result["faults"]] == [0, 1, 2, 3]
    for row in result["faults"]:
        drop, stale, corrupt = fault_masks(exp._fault_key, row["round"], N,
                                           exp.f, cfg.faults)
        assert row == {"round": row["round"],
                       "injected_dropout": int(drop.sum()),
                       "injected_straggler": int(stale.sum()),
                       "injected_corrupt": int(corrupt.sum()),
                       "quarantined": int(drop.sum() + corrupt.sum())}
    assert bool(torch.isfinite(exp.state.weights).all())
