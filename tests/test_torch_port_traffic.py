"""The port's population & traffic engine vs the JAX package's.

``core/population.py`` (a copy in the port) and the engine's traffic
rounds, on the CPU:

- the registry (client state, arrival rate, availability, the fill and
  the cohort), ``traffic_schedule`` and ``replay_traffic`` bit for bit
  against the JAX package's module, over seeds, populations from 19 to
  a million, diurnal and sybil-burst profiles; ``plan_action`` over every
  defense, fallback, f and cohort size;
- ``traffic_delays`` (the async latency draw) bit for bit against JAX's
  over seeds, rounds, tails and ring depths, and the latency scales;
- the million-client registry holds no population-sized array (the twin
  of the JAX package's ``test_registry_lazy_deterministic_million_
  clients``), and neither does a traffic engine or its schedule;
- flat traffic rounds through the engine against the JAX engine (XLA
  path) under remask, fallback and hold, with and without faults: each
  round's event equal, the weights within atol 1e-5
  (tests/test_torch_port_round.py's band), a hold round bit for bit a
  no-op with the round counter advancing; each action runs only the
  defense it names;
- async rounds with the latency profile against the JAX engine: the
  async state and counts exact, the weights within atol 1e-5; the port's
  ``replay_schedule`` against JAX's;
- the v11 'traffic' events of a run equal ``replay_traffic`` and pass
  the JAX package's ``validate_event``; a preempted run resumes bit for
  bit with every round's event exactly once;
- ``check_traffic_support``'s and ``TrafficConfig``'s messages word for
  word, the CLI's twelve flags with JAX's help texts and the
  ``TrafficConfig`` they build.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from attacking_federate_learning_tpu import cli as jax_cli
from attacking_federate_learning_tpu import config as JC
from attacking_federate_learning_tpu.attacks import DriftAttack as JDrift
from attacking_federate_learning_tpu.config import (
    ExperimentConfig as JConfig, FaultConfig as JFaultConfig,
    TrafficConfig as JTrafficConfig
)
from attacking_federate_learning_tpu.core import async_rounds as JA
from attacking_federate_learning_tpu.core import population as JP
from attacking_federate_learning_tpu.core.engine import (
    FederatedExperiment as JExperiment
)
from attacking_federate_learning_tpu.data.datasets import (
    load_dataset as jax_load_dataset
)
from attacking_federate_learning_tpu.utils.metrics import (
    validate_event as jax_validate_event
)
from attacking_federate_learning_tpu_torch import cli
from attacking_federate_learning_tpu_torch import config as C
from attacking_federate_learning_tpu_torch.attacks import DriftAttack
from attacking_federate_learning_tpu_torch.config import (
    ExperimentConfig, FaultConfig, TrafficConfig
)
from attacking_federate_learning_tpu_torch.core import async_rounds as A
from attacking_federate_learning_tpu_torch.core import population as P
from attacking_federate_learning_tpu_torch.core.engine import (
    FederatedExperiment
)
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

N, MAL_PROP, B, ROUNDS = 19, 0.22, 16, 5
SIZES = dict(synth_train=600, synth_test=100)
# n = 19, f = 4: Krum's bound 2f + 3 = 11, Median's 2f + 1 = 9.  This
# unreliable population walks the whole ladder in rounds 0..4 (planned
# with replay_traffic): fallback, hold, remask, remask, fallback.
LADDER = dict(population=32, rate=0.65, reliability_lo=0.3,
              reliability_hi=0.6, churn_dwell=2, seed=1)
FAULTS = dict(dropout=0.15, corrupt=0.1)
EVENT_KEYS = ("round", "arrived", "f_eff", "cohort", "action", "defense")


def _both(**kw):
    return JTrafficConfig(**kw), TrafficConfig(**kw)


# ---------------------------------------------------------------------------
# the registry and the schedule, bit for bit

_REGISTRIES = [  # (traffic kwargs, n, f, seed)
    (dict(population=256), 12, 2, 0),
    (dict(population=19, rate=0.5, churn_dwell=3), 19, 4, 7),
    (dict(population=5000, diurnal_amp=0.5, diurnal_period=6,
          reliability_lo=0.2, reliability_hi=0.9), 100, 24, 3),
    (dict(population=1000, sybil_burst_period=4, sybil_burst_width=1), 20,
     4, 11),
    (dict(population=1_000_000, seed=5, latency_scale=3.0), 16, 3, 2),
    (dict(population=40, rate=0.4), 10, 0, 1),
]


@pytest.mark.parametrize("tkw,n,f,seed", _REGISTRIES,
                         ids=[f"P{r[0]['population']}-n{r[1]}-f{r[2]}"
                              for r in _REGISTRIES])
def test_registry_is_jax_s_bit_for_bit(tkw, n, f, seed):
    jt, tt = _both(**tkw)
    ja, ta = JP.PopulationRegistry(jt, n, f, seed), P.PopulationRegistry(
        tt, n, f, seed)
    assert (ta.P, ta.F, ta.seed) == (ja.P, ja.F, ja.seed)
    pids = np.unique(np.concatenate([
        np.arange(min(ta.P, 300)), ta.P - 1 - np.arange(min(ta.P, 50)),
        [ta.F, max(ta.F - 1, 0)]]))
    js, ts = ja.client_state(pids), ta.client_state(pids)
    assert set(js) == set(ts)
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
        assert ts[k].dtype == js[k].dtype, k
    m_mal = f
    for t in range(12):
        assert ta.arrival_rate(t) == ja.arrival_rate(t)
        np.testing.assert_array_equal(ta.available(pids, t),
                                      ja.available(pids, t))
        for got, want in zip(ta.sample_cohort(t, n, m_mal),
                             ja.sample_cohort(t, n, m_mal)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
        for mal in (True, False):
            k = m_mal if mal else n - m_mal
            for got, want in zip(ta._fill(t, k, mal), ja._fill(t, k, mal)):
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("defense,fallback,tkw", [
    ("Krum", "Median", LADDER),
    ("Bulyan", "TrimmedMean", dict(population=60, rate=0.8)),
    ("TrimmedMean", "NoDefense", dict(population=25, rate=0.5,
                                      min_cohort=12)),
    ("NoDefense", "Median", dict(population=19, sybil_burst_period=3,
                                 sybil_burst_width=2)),
])
@pytest.mark.parametrize("participation", [1.0, 0.6])
def test_schedule_and_replay_are_jax_s(defense, fallback, tkw,
                                       participation):
    tkw = dict(tkw, fallback_defense=fallback)
    jt, tt = _both(**tkw)
    kw = dict(users_count=N, mal_prop=MAL_PROP, defense=defense,
              participation=participation)
    jcfg, tcfg = JConfig(**kw, traffic=jt), ExperimentConfig(**kw,
                                                             traffic=tt)
    assert P.replay_traffic(tcfg, 30) == JP.replay_traffic(jcfg, 30)
    reg_j = JP.PopulationRegistry(jt, N, 4, 0)
    reg_t = P.PopulationRegistry(tt, N, 4, 0)
    a = JP.traffic_schedule(reg_j, 3, 9, 11, 2, defense, fallback,
                            tt.min_cohort)
    b = P.traffic_schedule(reg_t, 3, 9, 11, 2, defense, fallback,
                           tt.min_cohort)
    assert (b.t0, b.count, b.events) == (a.t0, a.count, a.events)
    for name in ("shard_ids", "arrived", "action"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name))
        assert getattr(b, name).dtype == getattr(a, name).dtype


def test_the_ladder_config_walks_every_action():
    cfg = ExperimentConfig(users_count=N, mal_prop=MAL_PROP, defense="Krum",
                           traffic=TrafficConfig(**LADDER))
    acts = [e["action"] for e in P.replay_traffic(cfg, ROUNDS)]
    assert acts == ["fallback", "hold", "remask", "remask", "fallback"]


def test_plan_action_bounds_are_jax_s():
    assert P.ACTION_NAMES == JP.ACTION_NAMES
    assert (P.TRAFFIC_REMASK, P.TRAFFIC_FALLBACK, P.TRAFFIC_HOLD) == (
        JP.TRAFFIC_REMASK, JP.TRAFFIC_FALLBACK, JP.TRAFFIC_HOLD)
    assert set(P.DEFENSE_MIN_COHORT) == set(JP.DEFENSE_MIN_COHORT)
    for name in P.DEFENSE_MIN_COHORT:
        for fb in ("Median", "TrimmedMean", "NoDefense"):
            for f in (0, 1, 4, 24):
                assert (P.defense_min_cohort(name, f)
                        == JP.defense_min_cohort(name, f))
                for m_eff in range(0, 4 * f + 6):
                    for floor in (1, 5):
                        assert (P.plan_action(name, fb, m_eff, f, floor)
                                == JP.plan_action(name, fb, m_eff, f,
                                                  floor))
    # The declared bounds: Krum 2f+3, Bulyan 4f+3, the trims 2f+1.
    assert P.plan_action("Krum", "Median", 11, 4, 1) == P.TRAFFIC_REMASK
    assert P.plan_action("Krum", "Median", 10, 4, 1) == P.TRAFFIC_FALLBACK
    assert P.plan_action("Krum", "Median", 8, 4, 1) == P.TRAFFIC_HOLD
    assert P.plan_action("Bulyan", "Median", 18, 4, 1) == P.TRAFFIC_FALLBACK
    assert P.plan_action("NoDefense", "Median", 3, 4, 4) == P.TRAFFIC_HOLD


def test_splitmix_streams_are_jax_s():
    x = np.array([0, 1, 2 ** 63, 2 ** 64 - 1, 12345], np.uint64)
    np.testing.assert_array_equal(P._mix(x), JP._mix(x))
    np.testing.assert_array_equal(P._fold(x, 7), JP._fold(x, 7))
    np.testing.assert_array_equal(P._u01(x), JP._u01(x))


# ---------------------------------------------------------------------------
# the async latency profile

@pytest.mark.parametrize("tail,scale,depth", [(1.5, 1.0, 3), (1.2, 2.0, 6),
                                              (0.7, 0.5, 11),
                                              (3.0, 4.0, 2)])
def test_traffic_delays_are_jax_s(tail, scale, depth):
    kw = dict(users_count=100, mal_prop=0.24)
    jt, tt = _both(population=5000, latency_scale=scale, latency_tail=tail,
                   seed=4)
    jcfg, tcfg = JConfig(**kw, traffic=jt), ExperimentConfig(**kw,
                                                             traffic=tt)
    js, jtail = JP.async_latency_for_cfg(jcfg, 100)
    ts, ttail = P.async_latency_for_cfg(tcfg, 100)
    np.testing.assert_array_equal(ts, np.asarray(js))
    assert ts.dtype == np.float32 and ttail == jtail == tail
    for seed in (0, 1, 0xA57C):
        tkey = A.async_key(ExperimentConfig(seed=seed))
        jkey = JA.async_key(JConfig(seed=seed))
        for t in range(0, 40, 3):
            got = P.traffic_delays(tkey, t, ts, tail, depth)
            want = np.asarray(JP.traffic_delays(jkey, t, js, tail, depth))
            assert got.dtype == np.int32 and got.shape == (100,)
            np.testing.assert_array_equal(got, want)


def test_traffic_key_is_jax_s():
    for seed, tseed in ((0, None), (5, None), (5, 9)):
        jt, tt = _both(population=50, seed=tseed)
        jk = JP.traffic_key(JConfig(seed=seed, traffic=jt))
        tk = P.traffic_key(ExperimentConfig(seed=seed, traffic=tt))
        np.testing.assert_array_equal(tk, np.asarray(jax.random.key_data(
            jk)))


@pytest.mark.parametrize("faulted", [False, True], ids=["clean", "faulted"])
def test_async_replay_with_latency_is_jax_s(faulted):
    kw = dict(users_count=12, mal_prop=0.2, aggregation="async",
              async_buffer=5, async_max_staleness=3, seed=2)
    jt, tt = _both(population=100, latency_scale=1.5, latency_tail=1.1)
    jf = JFaultConfig(**FAULTS) if faulted else None
    tf = FaultConfig(**FAULTS) if faulted else None
    jcfg = JConfig(**kw, traffic=jt, faults=jf)
    tcfg = ExperimentConfig(**kw, traffic=tt, faults=tf)
    want = JA.replay_schedule(jcfg, 12, 2, 15)
    got = A.replay_schedule(tcfg, 12, 2, 15)
    plain = A.replay_schedule(dataclasses.replace(tcfg, traffic=None), 12,
                              2, 15)
    assert len(got) == len(want) == 15
    for g, w in zip(got, want):
        for k in ("delivered", "pending", "in_flight", "evicted",
                  "superseded", "staleness_hist"):
            assert g[k] == w[k], k
        np.testing.assert_array_equal(g["delivered_mask"],
                                      np.asarray(w["delivered_mask"]))
    assert [r["staleness_hist"] for r in got] != [
        r["staleness_hist"] for r in plain]


# ---------------------------------------------------------------------------
# no population-sized array anywhere

def test_registry_lazy_deterministic_million_clients():
    """P = 1,000,000: the registry holds scalars only (nothing on it
    scales with P), per-client state is a pure function of (seed, pid),
    two same-seed registries sample identical cohorts, another seed
    diverges (the twin of the JAX package's test)."""
    t = TrafficConfig(population=1_000_000)
    a = P.PopulationRegistry(t, n=16, f=3, seed=11)
    b = P.PopulationRegistry(t, n=16, f=3, seed=11)
    c = P.PopulationRegistry(t, n=16, f=3, seed=12)
    for reg in (a, b, c):
        for name, val in vars(reg).items():
            if isinstance(val, (np.ndarray, torch.Tensor)):
                assert val.size < 1024 if isinstance(val, np.ndarray) \
                    else val.numel() < 1024, name
    assert a.F == round(1_000_000 * 3 / 16)
    pids = np.array([0, a.F - 1, 999_999, a.F])
    sa, sb = a.client_state(pids), b.client_state(pids)
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k])
    assert sa["malicious"].tolist() == [True, True, False, False]
    assert (sa["shard"][sa["malicious"]] < 3).all()
    assert (sa["shard"][~sa["malicious"]] >= 3).all()
    for tt in (0, 5):
        for x, y in zip(a.sample_cohort(tt, 16, 3), b.sample_cohort(tt, 16,
                                                                     3)):
            np.testing.assert_array_equal(x, y)
        ids, arr, _ = a.sample_cohort(tt, 16, 3)
        assert ids.shape == (16,) and arr.dtype == bool
    assert not np.array_equal(a.sample_cohort(0, 16, 3)[2],
                              c.sample_cohort(0, 16, 3)[2])


def test_no_population_sized_array_in_an_engine(datasets):
    """A traffic engine over a million clients holds cohort-sized state
    only: every array and tensor on it, and its schedule, is far smaller
    than P; the traffic-off engine builds none of the machinery."""
    cfg = _cfg(traffic=TrafficConfig(population=1_000_000, seed=3))
    exp = FederatedExperiment(cfg, DriftAttack(1.0), datasets[1],
                              device="cpu")
    for name, val in vars(exp).items():
        size = (val.size if isinstance(val, np.ndarray) else val.numel()
                if isinstance(val, torch.Tensor) else 0)
        assert size < 1_000_000 or name in ("train_x", "train_y",
                                            "shards"), name
    sched = exp.traffic_plan(0, 4)
    assert sched.shard_ids.shape == (4, exp.m)
    assert (sched.shard_ids < exp.n).all()
    off = FederatedExperiment(_cfg(), DriftAttack(1.0), datasets[1],
                              device="cpu")
    assert off.traffic is None and off.registry is None


# ---------------------------------------------------------------------------
# flat traffic rounds through the engines

@pytest.fixture(scope="module")
def datasets():
    return (jax_load_dataset(JC.SYNTH_MNIST, seed=0, **SIZES),
            load_dataset(C.SYNTH_MNIST, seed=0, **SIZES))


def _cfg(**kw):
    base = dict(dataset=C.SYNTH_MNIST, users_count=N, mal_prop=MAL_PROP,
                batch_size=B, epochs=ROUNDS, test_step=ROUNDS,
                defense="Krum", **SIZES)
    return ExperimentConfig(**{**base, **kw})


def _pair(datasets, traffic, faults=None, **kw):
    """A JAX engine (XLA path) and a port engine on the CPU of one traffic
    config, the port started from the JAX engine's initial weights."""
    base = dict(dataset=C.SYNTH_MNIST, users_count=N, mal_prop=MAL_PROP,
                batch_size=B, epochs=ROUNDS, test_step=ROUNDS,
                defense="Krum", **SIZES)
    base.update(kw)
    jexp = JExperiment(
        JConfig(**base, traffic=JTrafficConfig(**traffic),
                faults=faults and JFaultConfig(**faults),
                aggregation_impl="xla", telemetry=faults is not None),
        attacker=JDrift(1.0), dataset=datasets[0])
    texp = FederatedExperiment(
        ExperimentConfig(**base, traffic=TrafficConfig(**traffic),
                         faults=faults and FaultConfig(**faults)),
        DriftAttack(1.0), datasets[1], device="cpu")
    params = jax.tree.map(np.asarray, jexp.flat.unravel(jexp.state.weights))
    texp.state = init_server_state(from_jax_params(params))
    return jexp, texp


_FLAT = [  # (label, defense, traffic, faults, extra config)
    ("ladder-Krum", "Krum", dict(LADDER), None, {}),
    ("ladder-Krum-faulted", "Krum", dict(LADDER), FAULTS, {}),
    ("ladder-Krum-fallback-TrimmedMean", "Krum",
     dict(LADDER, fallback_defense="TrimmedMean"), None, {}),
    ("ladder-TrimmedMean-faulted", "TrimmedMean", dict(LADDER), FAULTS, {}),
    ("diurnal-Median", "Median",
     dict(population=100_000, diurnal_amp=0.5, diurnal_period=4), None, {}),
    ("sybil-NoDefense", "NoDefense",
     dict(population=500, sybil_burst_period=3), None, {}),
    ("femnist-style-participation", "Krum", dict(population=300, rate=0.8),
     None, dict(partition="femnist_style", participation=0.8)),
]


@pytest.mark.parametrize("label,defense,traffic,faults,extra", _FLAT,
                         ids=[c[0] for c in _FLAT])
def test_flat_traffic_rounds_match_the_jax_engine(label, defense, traffic,
                                                  faults, extra, datasets):
    jexp, texp = _pair(datasets, traffic, faults, defense=defense, **extra)
    calls = []
    for name in ("defense_fn", "_traffic_fallback_fn"):
        inner = getattr(texp, name)

        def spy(G, n, f, inner=inner, name=name, **kw):
            calls.append((name, kw["mask"].clone()))
            return inner(G, n, f, **kw)

        setattr(texp, name, spy)
    actions = []
    for t in range(ROUNDS):
        w0 = texp.state.weights.clone()
        v0 = texp.state.velocity.clone()
        before = len(calls)
        jexp.run_round(t)
        texp.run_round(t)
        ev = texp._traffic_events[t]
        assert ev == jexp._traffic_events[t]
        actions.append(ev["action"])
        assert texp.state.round == t + 1
        ran = [c[0] for c in calls[before:]]
        if ev["action"] == "hold":
            assert ran == []
            assert torch.equal(texp.state.weights, w0)
            assert torch.equal(texp.state.velocity, v0)
        else:
            assert ran == [{"remask": "defense_fn",
                            "fallback": "_traffic_fallback_fn"}[
                                ev["action"]]]
            mask = calls[-1][1]
            assert int(mask.sum()) <= ev["arrived"]
            if faults is None:
                assert int(mask.sum()) == ev["arrived"]
        if faults is not None:
            want = {k[len("fault_"):]: int(v) for k, v in
                    jexp.last_round_telemetry.items()
                    if k.startswith("fault_")}
            got = {k: int(v) for k, v in texp.last_round_faults.items()
                   if k != "round"}
            assert got == want
        np.testing.assert_allclose(texp.state.weights.numpy(),
                                   np.asarray(jexp.state.weights), rtol=0,
                                   atol=1e-5)
    if label.startswith("ladder"):
        # TrimmedMean's bound 2f + 1 is Median's: it never falls back.
        assert set(actions) == ({"remask", "hold"} if defense == "TrimmedMean"
                                else {"remask", "fallback", "hold"})
    np.testing.assert_allclose(texp.state.velocity.numpy(),
                               np.asarray(jexp.state.velocity), rtol=0,
                               atol=1e-5)


def test_an_all_hold_run_freezes_the_weights(datasets):
    cfg = _cfg(epochs=4, traffic=TrafficConfig(population=32,
                                               min_cohort=64))
    exp = FederatedExperiment(cfg, DriftAttack(1.0), datasets[1],
                              device="cpu")
    w0, v0 = exp.state.weights.clone(), exp.state.velocity.clone()
    result = exp.run(log=lambda s: None)
    assert torch.equal(exp.state.weights, w0)
    assert torch.equal(exp.state.velocity, v0)
    assert exp.state.round == 4
    assert [e["action"] for e in result["traffic"]] == ["hold"] * 4


# ---------------------------------------------------------------------------
# async rounds with the latency profile

@pytest.mark.parametrize("defense,weighting,faults", [
    ("TrimmedMean", "poly", None), ("Krum", "const", None),
    ("Median", "none", FAULTS)])
def test_async_latency_rounds_match_the_jax_engine(defense, weighting,
                                                   faults, datasets):
    traffic = dict(population=200, latency_scale=1.5, latency_tail=1.2)
    jexp, texp = _pair(datasets, traffic, faults, defense=defense,
                       users_count=12, mal_prop=0.2, aggregation="async",
                       async_buffer=6, async_max_staleness=3,
                       staleness_weight=weighting)
    assert texp._traffic_latency is not None
    np.testing.assert_array_equal(texp._traffic_latency[0],
                                  np.asarray(jexp._traffic_latency[0]))
    rows = A.replay_schedule(texp.cfg, texp.m, texp.m_mal, ROUNDS)
    for t in range(ROUNDS):
        jexp.run_round(t)
        texp.run_round(t)
        tele, got = jexp.last_round_telemetry, texp.last_round_async
        for name, v in zip(A.COUNT_NAMES, got["counts"].tolist()):
            assert v == int(tele["async_" + name]), (t, name)
        for key in ("occ", "birth", "pocc", "pbirth"):
            np.testing.assert_array_equal(
                texp.async_state[key].numpy(),
                np.asarray(jexp._async_state[key]), err_msg=key)
        if faults is None:
            np.testing.assert_array_equal(got["delivered_mask"].numpy(),
                                          rows[t]["delivered_mask"])
    np.testing.assert_allclose(texp.state.weights.numpy(),
                               np.asarray(jexp.state.weights), rtol=0,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# events, resume

def test_traffic_events_equal_the_replay_and_jax_s_schema(datasets):
    cfg = _cfg(epochs=7, test_step=3,
               traffic=TrafficConfig(**LADDER),
               faults=FaultConfig(dropout=0.1))
    logger = RunLogger(cfg, log_dir=None, log=lambda s: None)
    exp = FederatedExperiment(cfg, DriftAttack(1.0), datasets[1],
                              device="cpu")
    result = exp.run(logger)
    got = [e for e in logger.events if e["kind"] == "traffic"]
    want = P.replay_traffic(cfg, cfg.epochs)
    assert [{k: e[k] for k in EVENT_KEYS} for e in got] == want
    assert result["traffic"] == want
    for e in got:
        jax_validate_event(dict(e))
    # At each boundary (rounds 0, 3, 6) the span's 'fault' events come
    # first, then its 'traffic' events, as in the JAX engine's span
    # emission.
    kinds = [e["kind"] for e in logger.events
             if e["kind"] in ("fault", "traffic")]
    span = ["fault"] * 3 + ["traffic"] * 3
    assert kinds == ["fault", "traffic"] + span + span
    assert exp._traffic_events == {}


def test_preempted_traffic_run_resumes_bit_for_bit(datasets, tmp_path):
    kw = dict(epochs=10, test_step=5, checkpoint_every=3,
              traffic=TrafficConfig(**LADDER),
              faults=FaultConfig(dropout=0.1, straggler=0.1))

    def cfg(root):
        return _cfg(**kw, run_dir=str(tmp_path / root / "runs"),
                    log_dir=str(tmp_path / root / "logs"))

    def engine(c):
        return FederatedExperiment(c, DriftAttack(1.0), datasets[1],
                                   device="cpu")

    whole = engine(cfg("one"))
    whole_log = RunLogger(whole.cfg, log_dir=None, log=lambda s: None)
    whole.run(whole_log)
    two = cfg("two")
    first = engine(two)
    journal = RunJournal(two.run_dir, "t")
    ck = Checkpointer(two, auto_dir=journal.dir)
    log1 = RunLogger(two, log_dir=None, log=lambda s: None)
    with pytest.raises(Preempted) as e:
        first.run(log1, checkpointer=ck, journal=journal,
                  shutdown=GracefulShutdown(preempt_at_round=4))
    assert e.value.round == 5
    second = engine(two)
    state, carry = ck.resume(ck.latest(), with_extra=True, device="cpu")
    second.state = state
    second.restore_carry_state(carry)
    journal = RunJournal(two.run_dir, "t")
    log2 = RunLogger(two, log_dir=None, log=lambda s: None)
    second.run(log2, checkpointer=Checkpointer(two, auto_dir=journal.dir),
               journal=journal)
    assert RunJournal(two.run_dir, "t").verify(epochs=10, test_step=5) == []
    assert torch.equal(second.state.weights, whole.state.weights)
    assert torch.equal(second.state.velocity, whole.state.velocity)
    def payloads(events):
        return [{k: e[k] for k in EVENT_KEYS} for e in events
                if e["kind"] == "traffic"]

    stitched = payloads(log1.events) + payloads(log2.events)
    assert [e["round"] for e in stitched] == list(range(10))
    assert stitched == payloads(whole_log.events) == P.replay_traffic(
        two, 10)


# ---------------------------------------------------------------------------
# refusals, config and CLI

def _refusal_cases():
    t = dict(population=256)
    return [
        dict(traffic=dict(population=4)),
        dict(defense="GeoMedian", traffic=t),
        dict(defense="DnC", traffic=t),
        dict(defense="FLTrust", traffic=t),
        dict(defense="Krum", traffic=t, aggregation="async",
             async_buffer=5),
        dict(backdoor="pattern", backdoor_fused=False, traffic=t),
    ]


@pytest.mark.parametrize("kw", _refusal_cases())
def test_check_traffic_support_messages_are_jax_s(kw):
    kw = dict(kw)
    tr = kw.pop("traffic")
    base = dict(users_count=12, mal_prop=0.2, defense="Krum")
    base.update(kw)
    try:
        jcfg = JConfig(**base, traffic=JTrafficConfig(**tr))
        tcfg = ExperimentConfig(**base, traffic=TrafficConfig(**tr))
    except ValueError as e:      # the staged backdoor: both configs refuse
        with pytest.raises(ValueError) as te:
            ExperimentConfig(**base, traffic=TrafficConfig(**tr))
        assert str(te.value) == str(e)
        return
    try:
        JP.check_traffic_support(jcfg)
    except ValueError as e:
        with pytest.raises(ValueError) as te:
            P.check_traffic_support(tcfg)
        assert str(te.value) == str(e)
    else:
        P.check_traffic_support(tcfg)


@pytest.mark.parametrize("kw", [
    dict(secagg="vanilla", defense="NoDefense"),
    dict(data_placement="host_stream"),
    dict(trimmed_mean_impl="host", defense="TrimmedMean"),
    dict(aggregation="hierarchical", megabatch=4, mesh_shape=(2, 1)),
])
def test_knobs_the_port_lacks_are_refused_with_jax_s_messages(kw):
    """The port's check reads secagg, host streaming, the host kernels and
    the SPMD mesh where a config carries them: on a JAX config it says
    what the JAX package says."""
    jcfg = JConfig(users_count=12, mal_prop=0.2, defense=kw.pop(
        "defense", "Krum"), traffic=JTrafficConfig(population=256), **kw)
    with pytest.raises(ValueError) as je:
        JP.check_traffic_support(jcfg)
    with pytest.raises(ValueError) as te:
        P.check_traffic_support(jcfg)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("kind", ["flat", "async"])
def test_engines_refuse_with_jax_s_messages(kind, datasets):
    kw = dict(defense="DnC", traffic=dict(population=256))
    if kind == "async":
        kw = dict(defense="Krum", traffic=dict(population=5),
                  aggregation="async", async_buffer=5)
    tr = kw.pop("traffic")
    base = dict(dataset=C.SYNTH_MNIST, users_count=12, mal_prop=0.2,
                batch_size=B, epochs=1, **SIZES, **kw)
    with pytest.raises(ValueError) as je:
        JExperiment(JConfig(**base, traffic=JTrafficConfig(**tr)),
                    attacker=JDrift(1.0), dataset=datasets[0])
    with pytest.raises(ValueError) as te:
        FederatedExperiment(ExperimentConfig(**base,
                                             traffic=TrafficConfig(**tr)),
                            DriftAttack(1.0), datasets[1], device="cpu")
    assert str(te.value) == str(je.value)


def test_traffic_config_defaults_and_messages_are_jax_s():
    assert dataclasses.asdict(TrafficConfig()) == dataclasses.asdict(
        JTrafficConfig())
    assert [f.name for f in dataclasses.fields(TrafficConfig)] == [
        f.name for f in dataclasses.fields(JTrafficConfig)]
    assert not TrafficConfig().enabled and TrafficConfig(
        population=1).enabled
    for kw in (dict(population=-1), dict(rate=0.0), dict(diurnal_amp=1.5),
               dict(diurnal_period=0), dict(reliability_lo=0.0),
               dict(reliability_lo=0.9, reliability_hi=0.8),
               dict(churn_dwell=0), dict(latency_scale=0.0),
               dict(latency_tail=-1.0), dict(sybil_burst_period=-1),
               dict(sybil_burst_period=3, sybil_burst_width=4),
               dict(fallback_defense="Krum"), dict(min_cohort=0)):
        with pytest.raises(ValueError) as je:
            JTrafficConfig(**kw)
        with pytest.raises(ValueError) as te:
            TrafficConfig(**kw)
        assert str(te.value) == str(je.value)
    # A dict coerces, as the JAX config's does (checkpoint JSON).
    cfg = ExperimentConfig(traffic={"population": 300, "rate": 0.5})
    assert cfg.traffic == TrafficConfig(population=300, rate=0.5)


def test_cli_traffic_flags_are_jax_s():
    def actions(parser):
        return {a.dest: (a.option_strings, a.default, a.choices, a.metavar,
                         a.type, a.help)
                for a in parser._actions if a.dest.startswith("traffic_")}

    got = actions(cli.build_parser())
    assert len(got) == 12
    assert got == actions(jax_cli.build_parser())


@pytest.mark.parametrize("argv", [
    [], ["--traffic-population", "1000"],
    ["--traffic-population", "150", "--traffic-rate", "0.35",
     "--traffic-diurnal-amp", "0.5", "--traffic-diurnal-period", "6",
     "--traffic-churn-dwell", "2", "--traffic-latency-scale", "2",
     "--traffic-latency-tail", "1.1", "--traffic-sybil-period", "4",
     "--traffic-sybil-width", "2", "--traffic-fallback", "TrimmedMean",
     "--traffic-min-cohort", "3", "--traffic-seed", "9"]])
def test_cli_builds_jax_s_traffic_config(argv):
    got = cli.config_from_args(cli.build_parser().parse_args(argv))
    want = jax_cli.config_from_args(jax_cli.build_parser().parse_args(argv))
    if want.traffic is None:
        assert got.traffic is None
    else:
        assert dataclasses.asdict(got.traffic) == dataclasses.asdict(
            want.traffic)


def test_cli_runs_a_traffic_round(tmp_path, capsys):
    result = cli.main(["-s", C.SYNTH_MNIST, "-n", "19", "-m", "0.22", "-d",
                       "Krum", "-e", "3", "-c", "16", "--synth-train", "600",
                       "--synth-test", "100", "--traffic-population", "32",
                       "--traffic-rate", "0.65", "--traffic-seed", "1",
                       "--log-dir", str(tmp_path), "--run-dir",
                       str(tmp_path / "runs"), "--device", "cpu"])
    assert len(result["traffic"]) == 3
    assert "Test set" in capsys.readouterr().out
