"""The port's asynchronous buffered round vs the JAX package's.

On the CPU at a small size (SYNTH_MNIST 256/64, n = 12, f = 2, B = 16,
``async_max_staleness`` 2, so a ring of depth 3), with the JAX init
carried into the port as numpy and both engines given the same explicit
datasets:

- the arrival schedule (``draw_delays``) bit for bit over seeds and
  rounds, with and without faults and a timed attacker;
- ``async_step`` threaded over 8 rounds on the same seeded (m, d)
  matrices: the six state arrays, the delivered mask, the staleness and
  every count bit-equal to the JAX function's;
- ``replay_schedule``, ``staleness_weights`` and the delivered-cohort
  statistics against the JAX package's;
- whole runs of ``FederatedExperiment`` against the JAX engine over 5
  rounds under the five defenses (tests/test_async.py's grid), faulted,
  and under ``backdoor_timed``: the async state's masks and births and
  every count exact each round, the weights within atol 1e-5
  (tests/test_torch_port_round.py's band), the weight mass within rtol
  1e-6;
- the empty-delivery no-op, the JAX package's rejection messages word
  for word, checkpoints with the ``async_*`` arrays read both ways and a
  preempted run resumed bit for bit, the CLI's four flags and the
  'async' events under the JAX package's ``validate_event``.
"""

import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attacking_federate_learning_tpu import cli as jax_cli
from attacking_federate_learning_tpu import config as JC
from attacking_federate_learning_tpu.attacks import DriftAttack as JDrift
from attacking_federate_learning_tpu.attacks import (
    make_attacker as jax_make_attacker
)
from attacking_federate_learning_tpu.attacks.base import (
    AttackContext as JContext, masked_cohort_stats as jax_masked_stats
)
from attacking_federate_learning_tpu.config import (
    ExperimentConfig as JConfig, FaultConfig as JFaultConfig
)
from attacking_federate_learning_tpu.core import async_rounds as JA
from attacking_federate_learning_tpu.core.engine import (
    FederatedExperiment as JExperiment
)
from attacking_federate_learning_tpu.core.faults import (
    fault_key as jax_fault_key
)
from attacking_federate_learning_tpu.data.datasets import (
    load_dataset as jax_load_dataset
)
from attacking_federate_learning_tpu.utils.checkpoint import (
    Checkpointer as JCheckpointer
)
from attacking_federate_learning_tpu.utils.metrics import (
    validate_event as jax_validate_event
)
from attacking_federate_learning_tpu_torch import cli
from attacking_federate_learning_tpu_torch import config as C
from attacking_federate_learning_tpu_torch.attacks import (
    AttackContext, DriftAttack, cohort_stats, delivered_cohort_stats,
    make_attacker, masked_cohort_stats
)
from attacking_federate_learning_tpu_torch.config import (
    ExperimentConfig, FaultConfig
)
from attacking_federate_learning_tpu_torch.core import async_rounds as A
from attacking_federate_learning_tpu_torch.core.engine import (
    FederatedExperiment
)
from attacking_federate_learning_tpu_torch.core.faults import fault_key
from attacking_federate_learning_tpu_torch.core.server import (
    init_server_state
)
from attacking_federate_learning_tpu_torch.data.datasets import load_dataset
from attacking_federate_learning_tpu_torch.utils.checkpoint import (
    Checkpointer
)
from attacking_federate_learning_tpu_torch.utils.lifecycle import (
    GracefulShutdown, Preempted, RunJournal
)
from attacking_federate_learning_tpu_torch.utils.metrics import RunLogger
from attacking_federate_learning_tpu_torch.utils.weights import (
    from_jax_params
)

N, MAL_PROP, B, ROUNDS = 12, 0.2, 16, 5
SIZES = dict(synth_train=256, synth_test=64)
FAULTS = dict(dropout=0.2, straggler=0.2, corrupt=0.1, straggler_delay=1,
              corrupt_mode="nan")
STATE_KEYS = ("buf", "occ", "birth", "pbuf", "pocc", "pbirth")


def _kw(**kw):
    base = dict(dataset=C.SYNTH_MNIST, users_count=N, mal_prop=MAL_PROP,
                batch_size=B, epochs=ROUNDS, test_step=ROUNDS,
                aggregation="async", async_buffer=7, async_max_staleness=2,
                **SIZES)
    return {**base, **kw}


@pytest.fixture(scope="module")
def datasets():
    return (jax_load_dataset(JC.SYNTH_MNIST, seed=0, **SIZES),
            load_dataset(C.SYNTH_MNIST, seed=0, **SIZES))


def _faults(kw, jax_side):
    fc = kw.pop("faults", None)
    if fc is None:
        return None
    return (JFaultConfig if jax_side else FaultConfig)(**fc)


def _pair(datasets, attack="alie", **kw):
    """A JAX engine (XLA path) and a port engine on the CPU of one async
    config, the port started from the JAX engine's initial weights."""
    kw = _kw(**kw)
    jcfg = JConfig(**{**kw, "faults": _faults(dict(kw), True)},
                   aggregation_impl="xla")
    tcfg = ExperimentConfig(**{**kw, "faults": _faults(dict(kw), False)})
    if attack == "alie":
        jatt, tatt = JDrift(1.0), DriftAttack(1.0)
    else:
        jatt = jax_make_attacker(jcfg, datasets[0], name=attack)
        tatt = make_attacker(tcfg, datasets[1], name=attack, device="cpu")
    jexp = JExperiment(jcfg, attacker=jatt, dataset=datasets[0])
    texp = FederatedExperiment(tcfg, tatt, datasets[1], device="cpu")
    params = jax.tree.map(np.asarray, jexp.flat.unravel(jexp.state.weights))
    texp.state = init_server_state(from_jax_params(params))
    return jexp, texp


def _spec_pair(k=7, max_staleness=2, weighting="none", timed=False):
    args = dict(buffer=k, max_staleness=max_staleness, weighting=weighting,
                timed=timed)
    return JA.AsyncSpec(**args), A.AsyncSpec(**args)


# ---------------------------------------------------------------------------
# the arrival schedule and the step, bit for bit

@pytest.mark.parametrize("faulted", [False, True], ids=["clean", "faulted"])
@pytest.mark.parametrize("timed", [False, True], ids=["untimed", "timed"])
@pytest.mark.parametrize("max_staleness", [0, 2, 4])
def test_draw_delays_are_jax_s_bit_for_bit(faulted, timed, max_staleness):
    jspec, tspec = _spec_pair(max_staleness=max_staleness, timed=timed)
    fc = dict(FAULTS, straggler_delay=2)
    for seed in (0, 1, 7, 12345):
        kw = dict(seed=seed, **({"faults": fc} if faulted else {}))
        jcfg = JConfig(**{**kw, "faults": _faults(dict(kw), True)})
        tcfg = ExperimentConfig(**{**kw, "faults": _faults(dict(kw), False)})
        jkey, tkey = JA.async_key(jcfg), A.async_key(tcfg)
        assert np.array_equal(np.asarray(jax.random.key_data(jkey)), tkey)
        jf = jcfg.faults if faulted else None
        tf = tcfg.faults if faulted else None
        jfk = jax_fault_key(jcfg) if faulted else None
        tfk = fault_key(tcfg) if faulted else None
        for t in range(10):
            want = JA.draw_delays(jkey, t, N, 2, jspec, jf, jfk)
            got = A.draw_delays(tkey, t, N, 2, tspec, tf, tfk)
            for w, g in zip(want, got):
                w = np.asarray(w)
                assert g.dtype == w.dtype and g.shape == (N,)
                np.testing.assert_array_equal(g, w)
            if timed:
                assert got[0][:2].tolist() == [0, 0]


# (name, spec kwargs, faults, m_mal)
_STEP_CASES = [
    ("clean", dict(k=7), None, 2),
    ("k=m", dict(k=N), None, 2),
    ("D=1", dict(k=5, max_staleness=0), None, 2),
    ("D=5", dict(k=4, max_staleness=4), None, 2),
    ("timed", dict(k=7, timed=True), None, 2),
    ("nan", dict(k=6), FAULTS, 2),
    ("inf", dict(k=6), dict(FAULTS, corrupt_mode="inf"), 2),
    ("scale", dict(k=6), dict(FAULTS, corrupt_mode="scale", corrupt=0.3,
                              corrupt_scale=1e30), 2),
    ("straggler3", dict(k=4, max_staleness=3),
     dict(straggler=0.4, straggler_delay=3), 0),
]


@pytest.mark.parametrize("name,spec,faults,m_mal", _STEP_CASES,
                         ids=[c[0] for c in _STEP_CASES])
def test_async_step_threads_like_jax_s(name, spec, faults, m_mal):
    """Eight rounds of the step on the same seeded matrices: the six state
    arrays, the delivered mask, the staleness and every count bit-equal;
    NaN and Inf cells too (``assert_array_equal`` matches NaN to NaN)."""
    jspec, tspec = _spec_pair(**spec)
    kw = {} if faults is None else {"faults": faults}
    jcfg = JConfig(seed=3, **{**kw, "faults": _faults(dict(kw), True)})
    tcfg = ExperimentConfig(seed=3,
                            **{**kw, "faults": _faults(dict(kw), False)})
    jkey, tkey = JA.async_key(jcfg), A.async_key(tcfg)
    jf = jcfg.faults if faults else None
    tf = tcfg.faults if faults else None
    jfk = jax_fault_key(jcfg) if faults else None
    tfk = fault_key(tcfg) if faults else None
    d = 9
    jstate = JA.init_async_state(jspec, N, d)
    tstate = A.init_async_state(tspec, N, d, "cpu")
    rng = np.random.default_rng(11)
    delivered_rounds = 0
    for t in range(8):
        G = rng.standard_normal((N, d), dtype=np.float32)
        jg, jdel, jstal, jstate, jstats = JA.async_step(
            jnp.asarray(G), t, jkey, jspec, jstate, m_mal, jf, jfk)
        tg, tdel, tstal, tstats = A.async_step(
            torch.from_numpy(G.copy()), t, tkey, tspec, tstate, m_mal, tf,
            tfk)
        for k in STATE_KEYS:
            w = np.asarray(jstate[k])
            assert tstate[k].numpy().dtype == w.dtype, k
            np.testing.assert_array_equal(tstate[k].numpy(), w, err_msg=k)
        np.testing.assert_array_equal(tdel.numpy(), np.asarray(jdel))
        np.testing.assert_array_equal(tstal.numpy(), np.asarray(jstal))
        assert tstal.dtype == torch.int32
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        counts = dict(zip(A.COUNT_NAMES, tstats["counts"].tolist()))
        for k, v in counts.items():
            assert v == int(jstats["async_" + k]), (t, k)
        np.testing.assert_array_equal(
            tstats["staleness_hist"].numpy(),
            np.asarray(jstats["async_staleness_hist"]))
        for k in ("fault_injected_dropout", "fault_injected_straggler",
                  "fault_injected_corrupt"):
            assert (k in tstats) == (faults is not None)
            if faults is not None:
                assert tstats[k] == int(jstats[k])
        delivered_rounds += counts["delivered"] > 0
    assert delivered_rounds > 0


@pytest.mark.parametrize("kw,timed", [
    ({}, False), ({}, True),
    (dict(faults=FAULTS), False),
    (dict(faults=FAULTS, async_max_staleness=4, async_buffer=5), True)],
    ids=["clean", "timed", "faulted", "faulted-timed-D5"])
def test_replay_schedule_is_jax_s(kw, timed):
    kw = dict(dict(users_count=N, mal_prop=MAL_PROP, aggregation="async",
                   async_buffer=7), **kw)
    jcfg = JConfig(**{**kw, "faults": _faults(dict(kw), True)})
    tcfg = ExperimentConfig(**{**kw, "faults": _faults(dict(kw), False)})
    want = JA.replay_schedule(jcfg, N, 2, 12, timed=timed)
    got = A.replay_schedule(tcfg, N, 2, 12, timed=timed)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]),
                                          np.asarray(w[k]), err_msg=k)
    if timed and "faults" not in kw:
        # A delivered timed row is always fresh (with dropout a pending
        # timed row can wait a round).
        for r in got:
            assert all(r["staleness"][i] == 0 for i in range(2)
                       if r["delivered_mask"][i])


@pytest.mark.parametrize("weighting", A.STALENESS_WEIGHTS)
def test_staleness_weights_are_jax_s(weighting):
    stal = np.array([0, 1, 2, -1, 3, 0, 7, -1, 1, 2, 0, 4], np.int32)
    delivered = stal >= 0
    delivered[4] = False            # a staleness without delivery: 0
    want = JA.staleness_weights(jnp.asarray(stal), jnp.asarray(delivered),
                                weighting)
    got = A.staleness_weights(torch.from_numpy(stal),
                              torch.from_numpy(delivered), weighting)
    if weighting == "none":
        assert got is None and want is None
        return
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    mass = A.weight_mass(torch.from_numpy(stal), torch.from_numpy(delivered),
                         got, 3)
    assert mass.tolist() == pytest.approx(
        [got[(stal == s) & delivered].sum().item() for s in range(3)],
        rel=1e-6)


# ---------------------------------------------------------------------------
# the delivered-cohort attack seam

_MASKS = {"partial": [True, False, True, True, False],
          "one": [False, False, False, True, False],
          "none": [False] * 5, "full": [True] * 5}


@pytest.mark.parametrize("which", list(_MASKS))
def test_masked_cohort_stats_are_jax_s(which):
    rng = np.random.default_rng(1)
    mal = rng.standard_normal((5, 40), dtype=np.float32)
    mask = np.array(_MASKS[which])
    jm, js = jax_masked_stats(jnp.asarray(mal), jnp.asarray(mask))
    tm, ts = masked_cohort_stats(torch.from_numpy(mal),
                                 torch.from_numpy(mask))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                               atol=1e-7)
    if which == "full":
        cm, cs = cohort_stats(torch.from_numpy(mal))
        np.testing.assert_allclose(tm.numpy(), cm.numpy(), rtol=1e-6)
        np.testing.assert_allclose(ts.numpy(), cs.numpy(), rtol=1e-6)
    # delivered_cohort_stats reads the mask off the context's staleness
    # (-1: not delivered), rows [0, f) of an (m,) vector.
    stal = torch.tensor([2 if x else -1 for x in mask] + [0, 0, 1],
                        dtype=torch.int32)
    ctx = AttackContext(torch.zeros(40), torch.tensor(0.1), staleness=stal)
    dm, ds = delivered_cohort_stats(torch.from_numpy(mal), ctx)
    assert torch.equal(dm, tm) and torch.equal(ds, ts)


def test_alie_craft_uses_the_delivered_cohort():
    rng = np.random.default_rng(0)
    mal = rng.standard_normal((4, 6), dtype=np.float32)
    stal = np.array([0, -1, 2, -1, 0, 0, 0, 0], np.int32)
    jctx = JContext(original_params=jnp.zeros(6),
                    learning_rate=jnp.float32(0.1),
                    staleness=jnp.asarray(stal))
    want = JDrift(1.5).craft(jnp.asarray(mal), jctx)
    ctx = AttackContext(torch.zeros(6), torch.tensor(0.1),
                        staleness=torch.from_numpy(stal))
    got = DriftAttack(1.5).craft(torch.from_numpy(mal), ctx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    sub = mal[stal[:4] >= 0]
    np.testing.assert_allclose(got.numpy(), sub.mean(0) - 1.5 * sub.std(0),
                               rtol=1e-5, atol=1e-6)
    # The flat round's context keeps the full-cohort statistics.
    flat = DriftAttack(1.5).craft(torch.from_numpy(mal), AttackContext(
        torch.zeros(6), torch.tensor(0.1)))
    m, s = cohort_stats(torch.from_numpy(mal))
    assert torch.equal(flat, m - 1.5 * s)


# ---------------------------------------------------------------------------
# whole runs against the JAX engine

# tests/test_async.py's grid (Bulyan's bound at n = k: k >= 4f + 3 = 11),
# then a faulted run and the timed backdoor.
_RUNS = [
    ("NoDefense", "none", 7, None, "alie"),
    ("Krum", "poly", 7, None, "alie"),
    ("TrimmedMean", "poly", 7, None, "alie"),
    ("Median", "const", 7, None, "alie"),
    ("Bulyan", "none", 11, None, "alie"),
    ("TrimmedMean", "poly", 6, FAULTS, "alie"),
    ("TrimmedMean", "poly", 7, None, "backdoor_timed"),
]


@pytest.mark.parametrize(
    "defense,weighting,k,faults,attack", _RUNS,
    ids=[f"{d}-{w}" + ("-faulted" if f else "")
         + ("-timed" if a != "alie" else "") for d, w, _, f, a in _RUNS])
def test_runs_match_the_jax_engine(defense, weighting, k, faults, attack,
                                   datasets):
    extra = {} if faults is None else {"faults": faults}
    if attack == "backdoor_timed":
        extra.update(backdoor="pattern", mal_batch_size=64, mal_epochs=2)
    jexp, texp = _pair(datasets, attack, defense=defense,
                       staleness_weight=weighting, async_buffer=k, **extra)
    assert texp.async_spec.timed == (attack == "backdoor_timed")
    assert texp.fault_state is None
    rows = A.replay_schedule(texp.cfg, texp.m, texp.m_mal, ROUNDS,
                             timed=texp.async_spec.timed)
    delivered_any = 0
    for t in range(ROUNDS):
        jexp.run_round(t)
        texp.run_round(t)
        tele, got = jexp.last_round_telemetry, texp.last_round_async
        for name, v in zip(A.COUNT_NAMES, got["counts"].tolist()):
            assert v == int(tele["async_" + name]), (t, name)
        np.testing.assert_array_equal(got["staleness_hist"].numpy(),
                                      np.asarray(tele["async_staleness_hist"]))
        np.testing.assert_allclose(got["weight_mass"].numpy(),
                                   np.asarray(tele["async_weight_mass"]),
                                   rtol=1e-6)
        for key in ("occ", "birth", "pocc", "pbirth"):
            np.testing.assert_array_equal(
                texp.async_state[key].numpy(),
                np.asarray(jexp._async_state[key]), err_msg=key)
        mask = got["delivered_mask"].numpy()
        assert mask.sum() in (0, k)
        delivered_any += bool(mask.any())
        if faults is None:
            # The host replay models no quarantine; without faults it is
            # exact.
            np.testing.assert_array_equal(mask, rows[t]["delivered_mask"])
            np.testing.assert_array_equal(got["staleness"].numpy(),
                                          rows[t]["staleness"])
        else:
            want = {k2[len("fault_"):]: int(v) for k2, v in tele.items()
                    if k2.startswith("fault_")}
            assert {k2: v for k2, v in texp.last_round_faults.items()
                    if k2 != "round"} == want
        if texp.async_spec.timed:
            stal = got["staleness"].numpy()
            assert all(stal[i] == 0 for i in range(texp.m_mal) if mask[i])
    assert delivered_any >= 2
    assert int(texp.state.round) == int(jexp.state.round) == ROUNDS
    np.testing.assert_allclose(texp.state.weights.numpy(),
                               np.asarray(jexp.state.weights), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(texp.state.velocity.numpy(),
                               np.asarray(jexp.state.velocity), rtol=0,
                               atol=1e-5)
    for key in ("buf", "pbuf"):
        np.testing.assert_allclose(texp.async_state[key].numpy(),
                                   np.asarray(jexp._async_state[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)


def test_empty_delivery_round_is_a_server_noop(datasets):
    """A round that delivers nothing holds weights and velocity bit for
    bit, and the round counter advances: a seed whose round 0 delivers
    nothing, then the next rounds until one delivers."""
    seed = next(s for s in range(200) if A.replay_schedule(
        ExperimentConfig(**_kw(seed=s)), N, 2, 1)[0]["delivered"] == 0)
    cfg = ExperimentConfig(**_kw(seed=seed, defense="TrimmedMean",
                                 staleness_weight="poly"))
    exp = FederatedExperiment(cfg, DriftAttack(1.0), datasets[1],
                              device="cpu")
    rows = A.replay_schedule(cfg, N, 2, ROUNDS)
    first = next(t for t, r in enumerate(rows) if r["delivered"])
    for t in range(first + 1):
        w0 = exp.state.weights.clone()
        v0 = exp.state.velocity.clone()
        exp.run_round(t)
        assert exp.state.round == t + 1
        held = (torch.equal(exp.state.weights, w0)
                and torch.equal(exp.state.velocity, v0))
        assert held == (t < first)


def test_async_events_pass_jax_s_validate_event(datasets, tmp_path):
    """run() writes one 'async' record a round, the JAX engine's fields
    and types, after the round's 'fault' record; the JAX package's
    validate_event accepts every event, and the records equal the JAX
    engine's own (the weight mass within rtol 1e-6)."""
    jexp, texp = _pair(datasets, defense="Krum", staleness_weight="const",
                       faults=FAULTS, async_buffer=6, test_step=2)
    with RunLogger(texp.cfg, None, str(tmp_path / "t"),
                   jsonl_name="port") as logger:
        result = texp.run(logger)
    with open(logger.jsonl_path) as f:
        events = [json.loads(line) for line in f]
    for e in events:
        jax_validate_event(e)
    kinds = [e["kind"] for e in events if e["kind"] in ("fault", "async")]
    assert kinds == ["fault", "async"] * ROUNDS
    av = [e for e in events if e["kind"] == "async"]
    assert [e["round"] for e in av] == list(range(ROUNDS))
    assert result["async"] == [{k: v for k, v in e.items()
                                if k not in ("kind", "v", "t")}
                               for e in av]
    jcfg = dataclasses.replace(jexp.cfg, log_dir=str(tmp_path / "j"))
    from attacking_federate_learning_tpu.utils.metrics import (
        RunLogger as JRunLogger
    )
    with JRunLogger(jcfg, None, jcfg.log_dir, jsonl_name="jax") as jl:
        jexp.run(jl)
    with open(jl.jsonl_path) as f:
        jav = [json.loads(line) for line in f]
    jav = [e for e in jav if e["kind"] == "async"]
    assert len(jav) == ROUNDS
    for got, want in zip(av, jav):
        assert set(got) == set(want)
        for k in want:
            if k == "weight_mass":
                np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
            elif k not in ("t",):
                assert got[k] == want[k], k
                assert type(got[k]) is type(want[k]), k


# ---------------------------------------------------------------------------
# rejections, word for word

@pytest.mark.parametrize("kw", [
    dict(aggregation="ring"), dict(staleness_weight="linear"),
    dict(async_buffer=-1), dict(async_max_staleness=-2),
    dict(aggregation="async", async_buffer=0)],
    ids=["aggregation", "weighting", "buffer", "staleness", "no-buffer"])
def test_config_messages_are_jax_s(kw):
    with pytest.raises(ValueError) as je:
        JConfig(**kw)
    with pytest.raises(ValueError) as te:
        ExperimentConfig(**kw)
    assert str(te.value) == str(je.value)


def test_config_defaults_are_jax_s():
    j, t = JConfig(), ExperimentConfig()
    for name in ("aggregation", "async_buffer", "async_max_staleness",
                 "staleness_weight"):
        assert getattr(t, name) == getattr(j, name), name
    # Inert outside async, as in the JAX package.
    ExperimentConfig(async_max_staleness=7, staleness_weight="poly")


def test_hierarchical_is_refused_as_not_ported():
    """The hierarchical round is ported now
    (tests/test_torch_port_hierarchy.py): the config takes it with a
    megabatch, as JAX's does, and refuses it without one with JAX's
    message."""
    JConfig(aggregation="hierarchical", megabatch=5)
    ExperimentConfig(aggregation="hierarchical", megabatch=5)
    with pytest.raises(ValueError) as je:
        JConfig(aggregation="hierarchical")
    with pytest.raises(ValueError) as te:
        ExperimentConfig(aggregation="hierarchical")
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("kw", [
    dict(participation=0.5), dict(async_buffer=13),
    dict(defense="Bulyan", async_buffer=10),
    dict(defense="Krum", async_buffer=4, mal_prop=0.25),
    dict(defense="TrimmedMean", async_buffer=3)],
    ids=["participation", "buffer>m", "bulyan-at-k", "krum-at-k",
         "trimmed-k-f-1"])
def test_engine_messages_are_jax_s(kw, datasets):
    kw = _kw(**kw)
    with pytest.raises(ValueError) as je:
        JExperiment(JConfig(**kw), attacker=JDrift(1.0),
                    dataset=datasets[0])
    with pytest.raises(ValueError) as te:
        FederatedExperiment(ExperimentConfig(**kw), DriftAttack(1.0),
                            datasets[1], device="cpu")
    assert str(te.value) == str(je.value)


def test_non_mask_aware_defense_message_is_jax_s():
    cfg = dict(defense="GeoMedian", participation=1.0)
    with pytest.raises(ValueError) as je:
        JA.check_async_support(JConfig(**_kw(defense="GeoMedian")))
    with pytest.raises(ValueError) as te:
        A.check_async_support(types.SimpleNamespace(**cfg))
    assert str(te.value) == str(je.value)


def test_timed_attack_without_async_message_is_jax_s(datasets):
    kw = _kw(aggregation="flat", async_buffer=0, backdoor="pattern",
             mal_batch_size=64)
    jcfg, tcfg = JConfig(**kw), ExperimentConfig(**kw)
    with pytest.raises(ValueError) as je:
        JExperiment(jcfg, attacker=jax_make_attacker(
            jcfg, datasets[0], name="backdoor_timed"), dataset=datasets[0])
    att = make_attacker(tcfg, datasets[1], name="backdoor_timed",
                        device="cpu")
    assert att.timed and att.name == "backdoor_timed"
    with pytest.raises(ValueError) as te:
        FederatedExperiment(tcfg, att, datasets[1], device="cpu")
    assert str(te.value) == str(je.value)


def test_async_raises_without_a_card(datasets):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FederatedExperiment(ExperimentConfig(**_kw()), DriftAttack(1.0),
                            datasets[1])


# ---------------------------------------------------------------------------
# checkpoints and resume

def test_carry_state_has_jax_s_keys_and_dtypes(datasets):
    jexp, texp = _pair(datasets, defense="Median", staleness_weight="poly")
    for t in range(3):
        jexp.run_round(t)
        texp.run_round(t)
    got, want = texp.carry_state_host(), jexp.carry_state_host()
    assert set(got) == set(want) == {"async_" + k for k in STATE_KEYS}
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == (
            want[k].shape), k
    bad = dict(got, async_pbuf=got["async_pbuf"][:, :-1])
    with pytest.raises(ValueError, match="async_pbuf has shape"):
        texp.restore_carry_state(bad)


@pytest.mark.parametrize("direction", ["port-to-jax", "jax-to-port"])
def test_checkpoints_carry_the_async_state_both_ways(direction, datasets,
                                                     tmp_path):
    """A checkpoint written at round 3 by one package resumes in the other
    and runs on to round 5 within atol 1e-5 of the writer's own run; the
    restored async arrays equal the written ones."""
    jexp, texp = _pair(datasets, defense="TrimmedMean",
                       staleness_weight="poly",
                       run_dir=str(tmp_path / "runs"))
    writer, reader = ((texp, jexp) if direction == "port-to-jax"
                      else (jexp, texp))
    for t in range(3):
        writer.run_round(t)
    if writer is texp:
        path = Checkpointer(texp.cfg).save_auto(
            texp.state, extra=texp.carry_state_host())
        state, extra = JCheckpointer(jexp.cfg).resume(path, with_extra=True)
        assert int(state.round) == 3
    else:
        path = JCheckpointer(jexp.cfg).save_auto(
            jexp.state, extra=jexp.carry_state_host())
        state, extra = Checkpointer(texp.cfg).resume(path, with_extra=True,
                                                     device="cpu")
        assert state.round == 3
    saved = writer.carry_state_host()
    assert set(extra) == set(saved)
    for k in saved:
        assert extra[k].dtype == saved[k].dtype, k
    # The reader continues from the writer's round-3 state.
    reader.state = state
    reader.restore_carry_state(extra)
    back = reader.carry_state_host()
    for k in saved:
        np.testing.assert_array_equal(back[k], saved[k], err_msg=k)
    for t in range(3, ROUNDS):
        writer.run_round(t)
        reader.run_round(t)
    np.testing.assert_allclose(np.asarray(reader.state.weights),
                               np.asarray(writer.state.weights), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(reader.state.velocity),
                               np.asarray(writer.state.velocity), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("faulted", [False, True], ids=["clean", "faulted"])
def test_preempted_run_resumes_bit_for_bit(faulted, datasets, tmp_path):
    """A journaled async run preempted at a boundary and resumed from its
    auto-checkpoint, the ring and the pool in ``extra=``, ends bit for bit
    where the whole run ends, buffers included."""
    extra = {"faults": FAULTS} if faulted else {}
    kw = _kw(defense="Krum", staleness_weight="poly", epochs=10,
             test_step=5, checkpoint_every=3, **extra)
    fc = FaultConfig(**FAULTS) if faulted else None

    def cfg(root):
        return ExperimentConfig(**{**kw, "faults": fc,
                                   "run_dir": str(tmp_path / root / "runs"),
                                   "log_dir": str(tmp_path / root / "logs")})

    def engine(c):
        return FederatedExperiment(c, DriftAttack(1.0), datasets[1],
                                   device="cpu")

    whole = engine(cfg("one"))
    whole.run(log=lambda s: None)
    two = cfg("two")
    first = engine(two)
    journal = RunJournal(two.run_dir, "p")
    ck = Checkpointer(two, auto_dir=journal.dir)
    with pytest.raises(Preempted) as e:
        first.run(checkpointer=ck, journal=journal, log=lambda s: None,
                  shutdown=GracefulShutdown(preempt_at_round=4))
    assert e.value.round == 5
    with np.load(ck.latest()) as z:
        assert int(z["round"]) == 6
        assert z["extra_async_buf"].shape == (3, N, whole.flat.dim)
        assert z["extra_async_occ"].dtype == np.bool_
        assert z["extra_async_birth"].dtype == np.int32
    second = engine(two)
    state, carry = ck.resume(ck.latest(), with_extra=True, device="cpu")
    second.state = state
    second.restore_carry_state(carry)
    journal = RunJournal(two.run_dir, "p")
    second.run(checkpointer=Checkpointer(two, auto_dir=journal.dir),
               journal=journal, log=lambda s: None)
    assert RunJournal(two.run_dir, "p").verify(epochs=10, test_step=5) == []
    assert torch.equal(second.state.weights, whole.state.weights)
    assert torch.equal(second.state.velocity, whole.state.velocity)
    a, b = second.carry_state_host(), whole.carry_state_host()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ---------------------------------------------------------------------------
# the CLI

_FLAGS = ("aggregation", "async_buffer", "async_max_staleness",
          "staleness_weight", "attack")


def test_cli_async_flags_are_jax_s():
    def actions(parser):
        return {a.dest: (a.option_strings, a.default, a.choices, a.metavar,
                         a.type, a.help)
                for a in parser._actions if a.dest in _FLAGS}

    got = actions(cli.build_parser())
    assert set(got) == set(_FLAGS)
    assert got == actions(jax_cli.build_parser())


@pytest.mark.parametrize("flags", [
    [], ["--aggregation", "async", "--async-buffer", "5"],
    ["--aggregation", "async", "--async-buffer", "8",
     "--async-max-staleness", "4", "--staleness-weight", "const"]])
def test_cli_builds_jax_s_async_config(flags):
    got = cli.config_from_args(cli.build_parser().parse_args(flags))
    want = jax_cli.config_from_args(jax_cli.build_parser().parse_args(flags))
    for name in ("aggregation", "async_buffer", "async_max_staleness",
                 "staleness_weight"):
        assert getattr(got, name) == getattr(want, name), name


def test_cli_runs_backdoor_timed_under_async(tmp_path, capsys):
    result = cli.main(["-s", C.SYNTH_MNIST, "-n", str(N), "-m", "0.2",
                       "-e", "3", "-c", "16", "-d", "TrimmedMean",
                       "-b", "pattern", "--attack", "backdoor_timed",
                       "--aggregation", "async", "--async-buffer", "7",
                       "--staleness-weight", "poly", "--synth-train",
                       "256", "--synth-test", "64", "--device", "cpu",
                       "--log-dir", str(tmp_path / "logs"),
                       "--run-dir", str(tmp_path / "runs")])
    out = capsys.readouterr().out
    assert "BEFORE:" in out and "##Test malicious net: [POST]" in out
    assert len(result["async"]) == 3
    assert np.isfinite(result["final_weights"].numpy()).all()
    logs = os.listdir(tmp_path / "logs")
    assert any(name.endswith(".jsonl") for name in logs)
