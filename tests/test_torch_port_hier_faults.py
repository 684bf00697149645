"""The hierarchical round's fault domains, ladder and slot resampling vs
the JAX package's.

On the CPU:

- ``shard_fault_masks``, ``domain_alive_row``, ``hier_fault_schedule``,
  ``plan_tier2_actions`` and ``resample_slots`` bit for bit the JAX
  package's over seeds, rounds, shards, rates and dwells;
- faulted hierarchical rounds (dropout, NaN corruption, shard-domain
  dropout with dwell 2, stragglers at delay 2, and all at once) against
  the JAX engine's sequential hierarchical rounds: every round's fault
  counts, per-shard alive counts and ladder action equal, the straggler
  ring within 1e-6 of JAX's, the weights within a relative L2 error of
  1e-6; the ladder config walks remask, fallback and hold, a hold round
  leaves weights and velocity bit for bit.  (Masked Bulyan stays out of
  these runs: at m = 8 with two rows dropped its tail keeps 1 of 4
  values, the one nearer the midpoint of the middle two, an exact tie
  that the last bit of the gradients decides, in either engine);
- hierarchical rounds under traffic: the slots are JAX's draw, the
  weights within the same band;
- the v13 'fault' events of a run equal the host replay (and the JAX
  engine's events) and pass the JAX package's ``validate_event``;
- the (delay, S, m, d) ring's checkpoint loads in both directions
  between the port and the JAX package, and a resumed run continues bit
  for bit; a ring of another shape is refused;
- ``check_fault_support``'s hierarchical branches and the CLI.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from attacking_federate_learning_tpu import config as JC
from attacking_federate_learning_tpu.attacks import DriftAttack as JDrift
from attacking_federate_learning_tpu.config import (
    ExperimentConfig as JConfig, FaultConfig as JFaultConfig,
    TrafficConfig as JTrafficConfig
)
from attacking_federate_learning_tpu.core import faults as JF
from attacking_federate_learning_tpu.core import population as JP
from attacking_federate_learning_tpu.core.engine import (
    FederatedExperiment as JExperiment
)
from attacking_federate_learning_tpu.data.datasets import (
    load_dataset as jax_load_dataset
)
from attacking_federate_learning_tpu.ops import federated as JFD
from attacking_federate_learning_tpu.utils.checkpoint import (
    Checkpointer as JCheckpointer
)
from attacking_federate_learning_tpu.utils.metrics import (
    RunLogger as JRunLogger, validate_event as jax_validate_event
)
from attacking_federate_learning_tpu_torch import cli
from attacking_federate_learning_tpu_torch import config as C
from attacking_federate_learning_tpu_torch.attacks import DriftAttack
from attacking_federate_learning_tpu_torch.config import (
    ExperimentConfig, FaultConfig, TrafficConfig
)
from attacking_federate_learning_tpu_torch.core import faults as F
from attacking_federate_learning_tpu_torch.core import population as P
from attacking_federate_learning_tpu_torch.core.engine import (
    FederatedExperiment
)
from attacking_federate_learning_tpu_torch.core.server import (
    init_server_state
)
from attacking_federate_learning_tpu_torch.data.datasets import load_dataset
from attacking_federate_learning_tpu_torch.ops import federated as FD
from attacking_federate_learning_tpu_torch.utils import threefry
from attacking_federate_learning_tpu_torch.utils.checkpoint import (
    Checkpointer
)
from attacking_federate_learning_tpu_torch.utils.metrics import RunLogger
from attacking_federate_learning_tpu_torch.utils.weights import (
    from_jax_params
)

N, M, MAL_PROP, B = 40, 8, 0.2, 16      # S = 5, f = 8: f1 = 2, f2 = 1
SIZES = dict(synth_train=800, synth_test=100)
REL_L2 = 1e-6
# Five shards under tier-2 Krum (bound 2 f2 + 3 = 5): a dead shard sends
# the round to the Median fallback (2 f2 + 1 = 3), three dead to hold.
# This config's domain schedule (planned with the JAX package's
# hier_fault_schedule, checked below) walks all three in rounds 0..5.
# (remask, remask, fallback, hold, fallback, fallback).
LADDER = dict(shard_dropout=0.3, shard_dropout_dwell=2, seed=5)


def _both_faults(**kw):
    return JFaultConfig(**kw), FaultConfig(**kw)


def _key(seed):
    return threefry.key(seed ^ 0x0FA7175), jax.random.key(seed ^ 0x0FA7175)


# ---------------------------------------------------------------------------
# the draws, bit for bit

_RATES = [dict(dropout=0.2, straggler=0.3, corrupt=0.25, straggler_delay=2),
          dict(dropout=0.05, corrupt=0.5, corrupt_mode="scale"),
          dict(straggler=0.6, straggler_delay=3, corrupt=0.1,
               corrupt_mode="inf")]


@pytest.mark.parametrize("rates", _RATES, ids=["all", "scale", "inf"])
def test_shard_fault_masks_are_jax_s(rates):
    jf, tf = _both_faults(**rates)
    for seed in (0, 7):
        tk, jk = _key(seed)
        for t in (0, 1, 2, 5, 11):
            for sid in (0, 1, 6, 99):
                for m, c in ((8, 0), (8, 3), (13, 13), (100, 24)):
                    got = F.shard_fault_masks(tk, t, sid, m, c, tf)
                    want = JF.shard_fault_masks(jk, t, sid, m, c, jf)
                    for g, w in zip(got, want):
                        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("rate,dwell", [(0.0, 1), (0.2, 1), (0.3, 2),
                                        (0.5, 4)])
def test_domain_alive_row_is_jax_s(rate, dwell):
    jf, tf = _both_faults(shard_dropout=rate, shard_dropout_dwell=dwell)
    for seed in (0, 3):
        tk, jk = _key(seed)
        for t in range(9):
            for S in (2, 5, 10, 100):
                got = F.domain_alive_row(tk, t, S, tf)
                want = np.asarray(JF.domain_alive_row(jk, t, S, jf))
                np.testing.assert_array_equal(got, want)
                assert got.dtype == want.dtype


@pytest.mark.parametrize("placement", ["spread", "concentrated"])
def test_hier_fault_schedule_is_jax_s(placement):
    rates = dict(dropout=0.15, straggler=0.2, straggler_delay=2,
                 corrupt=0.1, shard_dropout=0.25, shard_dropout_dwell=2)
    for mode in ("nan", "scale"):
        jf, tf = _both_faults(corrupt_mode=mode, **rates)
        tk, jk = _key(5)
        for n, f, m in ((40, 8, 8), (1000, 240, 100)):
            tp = FD.make_placement(n, f, m, placement)
            jp = JFD.make_placement(n, f, m, placement)
            assert F.hier_fault_schedule(tk, 2, 4, tp, tf) == \
                JF.hier_fault_schedule(jk, 2, 4, jp, jf)


def test_plan_tier2_actions_are_jax_s():
    for name in ("NoDefense", "Krum", "TrimmedMean", "Bulyan", "Median"):
        for f2 in range(0, 4):
            alive = list(range(0, 16))
            got = F.plan_tier2_actions(alive, name, f2)
            want = JF.plan_tier2_actions(alive, name, f2)
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
    assert F.TIER2_FALLBACK == JF.TIER2_FALLBACK
    assert F._DOMAIN_SALT == JF._DOMAIN_SALT


@pytest.mark.parametrize("n,f,m", [(20, 4, 5), (1000, 240, 100),
                                   (40, 0, 8), (10_000, 2400, 100)])
def test_resample_slots_are_jax_s(n, f, m):
    for seed in (0, 9):
        cfg = JConfig(users_count=n, mal_prop=f / n, traffic=JTrafficConfig(
            population=max(n, 10_000), seed=seed))
        jk = JP.traffic_key(cfg)
        tk = P.traffic_key(cfg)
        for placement in ("spread", "concentrated"):
            place = FD.make_placement(n, f, m, placement)
            for t in (0, 1, 17):
                for s in sorted({0, 1, place.num_shards - 1}):
                    ids = place.grid[s].astype(np.int64)
                    c = place.mal_counts[s]
                    got = P.resample_slots(tk, t, ids, c, f, n)
                    want = np.asarray(JP.resample_slots(
                        jk, t, jax.numpy.asarray(place.grid[s]), c, f, n))
                    np.testing.assert_array_equal(got, want)
                    assert (got[:c] < max(f, 1)).all()
                    assert ((got[c:] >= f) & (got[c:] < n)).all()


def test_init_hier_fault_state_shapes():
    tf = FaultConfig(straggler=0.1, straggler_delay=3)
    st = F.init_hier_fault_state(tf, 5, 8, 17, "cpu")
    assert st["stale"].shape == (3, 5, 8, 17)
    assert st["stale"].dtype == torch.float32 and not st["stale"].any()
    assert F.init_hier_fault_state(FaultConfig(dropout=0.1), 5, 8, 17,
                                   "cpu") == {}


# ---------------------------------------------------------------------------
# faulted rounds through the engines

@pytest.fixture(scope="module")
def datasets():
    return (jax_load_dataset(JC.SYNTH_MNIST, seed=0, **SIZES),
            load_dataset(C.SYNTH_MNIST, seed=0, **SIZES))


def _base(**kw):
    base = dict(dataset=C.SYNTH_MNIST, users_count=N, mal_prop=MAL_PROP,
                batch_size=B, epochs=6, test_step=3,
                aggregation="hierarchical", megabatch=M, **SIZES)
    base.update(kw)
    return base


def _pair(datasets, faults=None, traffic=None, **kw):
    base = _base(**kw)
    jexp = JExperiment(
        JConfig(**base, aggregation_impl="xla",
                faults=faults and JFaultConfig(**faults),
                traffic=traffic and JTrafficConfig(**traffic)),
        attacker=JDrift(1.0), dataset=datasets[0])
    texp = FederatedExperiment(
        ExperimentConfig(**base, faults=faults and FaultConfig(**faults),
                         traffic=traffic and TrafficConfig(**traffic)),
        DriftAttack(1.0), datasets[1], device="cpu")
    params = jax.tree.map(np.asarray, jexp.flat.unravel(jexp.state.weights))
    texp.state = init_server_state(from_jax_params(params))
    return jexp, texp


def rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _host_faults(texp):
    (rec, _), = texp._host_records([(texp.last_round_faults, None)])
    return rec


def _jax_faults(jexp):
    out = {}
    for k, v in jexp.last_round_telemetry.items():
        if k.startswith("fault_"):
            v = np.asarray(v)
            out[k[len("fault_"):]] = (v.tolist() if v.ndim else int(v))
    return out


_FAULTED = [  # (label, tier 1, tier 2, faults, rounds, extra config)
    ("dropout", "TrimmedMean", "Krum", dict(dropout=0.15), 3, {}),
    ("nan", "Median", "TrimmedMean",
     dict(corrupt=0.1, corrupt_mode="nan"), 3, {}),
    ("shard-dwell2-ladder", "TrimmedMean", "Krum", LADDER, 6, {}),
    ("stragglers", "Krum", "Median",
     dict(straggler=0.3, straggler_delay=2, dropout=0.05), 5, {}),
    ("all-concentrated", "Krum", "NoDefense",
     dict(dropout=0.1, corrupt=0.05, shard_dropout=0.2,
          shard_dropout_dwell=2, straggler=0.2, straggler_delay=2), 5,
     dict(mal_placement="concentrated")),
]


@pytest.mark.parametrize("label,tier1,tier2,faults,rounds,extra", _FAULTED,
                         ids=[c[0] for c in _FAULTED])
def test_faulted_rounds_match_the_jax_engine(label, tier1, tier2, faults,
                                             rounds, extra, datasets):
    jexp, texp = _pair(datasets, faults, defense=tier1,
                       tier2_defense=tier2, **extra)
    want_rows = JF.hier_fault_schedule(jexp._fault_key, 0, rounds,
                                       jexp._placement, jexp.faults)
    actions = []
    for t in range(rounds):
        w0, v0 = texp.state.weights.clone(), texp.state.velocity.clone()
        jexp.run_round(t)
        texp.run_round(t)
        got, want = _host_faults(texp), _jax_faults(jexp)
        assert got == {"round": t, **want}
        assert {k: got[k] for k in want_rows[t]} == want_rows[t]
        actions.append(got["tier2_action"])
        if got["tier2_action"] == P.TRAFFIC_HOLD:
            assert torch.equal(texp.state.weights, w0)
            assert torch.equal(texp.state.velocity, v0)
        assert texp.state.round == t + 1
        if "straggler" in faults:
            np.testing.assert_allclose(
                texp.fault_state["stale"].numpy(),
                np.asarray(jexp._fault_state["stale"]), rtol=0, atol=1e-6)
    if label == "shard-dwell2-ladder":
        assert set(actions) == {P.TRAFFIC_REMASK, P.TRAFFIC_FALLBACK,
                                P.TRAFFIC_HOLD}
    assert rel_l2(texp.state.weights.numpy(),
                  np.asarray(jexp.state.weights)) <= REL_L2
    assert rel_l2(texp.state.velocity.numpy(),
                  np.asarray(jexp.state.velocity)) <= REL_L2


def test_each_action_runs_only_its_tier2_defense(datasets):
    _, texp = _pair(datasets, LADDER, defense="TrimmedMean",
                    tier2_defense="Krum")
    calls = []
    for name in ("_tier2_fn", "_tier2_fallback_fn"):
        inner = getattr(texp, name)

        def spy(E, S, f2, alive_counts=None, inner=inner, name=name):
            calls.append(name)
            assert int((alive_counts > 0).sum()) >= 1
            return inner(E, S, f2, alive_counts=alive_counts)

        setattr(texp, name, spy)
    for t in range(6):
        before = len(calls)
        texp.run_round(t)
        action = texp.last_round_faults["tier2_action"]
        assert calls[before:] == {
            P.TRAFFIC_REMASK: ["_tier2_fn"],
            P.TRAFFIC_FALLBACK: ["_tier2_fallback_fn"],
            P.TRAFFIC_HOLD: []}[action]


def test_dead_shard_estimates_are_zeroed_and_excluded(datasets):
    _, texp = _pair(datasets, dict(shard_dropout=0.5, seed=2),
                    defense="Median", tier2_defense="NoDefense")
    seen = []
    inner = texp._tier2_fn

    def spy(E, S, f2, alive_counts=None):
        seen.append((E.clone(), alive_counts.clone()))
        return inner(E, S, f2, alive_counts=alive_counts)

    texp._tier2_fn = spy
    for t in range(4):
        texp.run_round(t)
    dead = [(E, a) for E, a in seen if (a == 0).any()]
    assert dead
    for E, a in dead:
        assert not E[a == 0].any()
        assert torch.isfinite(E).all()


def test_traffic_rounds_resample_jax_s_slots(datasets):
    traffic = dict(population=5000, seed=3)
    jexp, texp = _pair(datasets, traffic=traffic, defense="Krum",
                       tier2_defense="Median")
    place = texp._placement
    for t in range(3):
        jexp.run_round(t)
        texp.run_round(t)
        want = np.stack([np.asarray(JP.resample_slots(
            jexp._traffic_key, t, jax.numpy.asarray(place.grid[s]),
            place.mal_counts[s], texp.f, texp.n))
            for s in range(place.num_shards)])
        np.testing.assert_array_equal(texp.last_round_slots, want)
        assert not np.array_equal(texp.last_round_slots, place.grid)
    assert rel_l2(texp.state.weights.numpy(),
                  np.asarray(jexp.state.weights)) <= REL_L2


# ---------------------------------------------------------------------------
# events, checkpoints and resume

EVENT_FAULTS = dict(dropout=0.1, corrupt=0.1, shard_dropout=0.3,
                    shard_dropout_dwell=2, seed=4)


def _fault_events(path):
    with open(path) as f:
        evs = [json.loads(line) for line in f]
    return [e for e in evs if e["kind"] == "fault"]


def test_v13_fault_events_equal_the_replay_and_jax_s(datasets, tmp_path):
    base = _base(defense="TrimmedMean", tier2_defense="Krum",
                 log_dir=str(tmp_path / "t"))
    tcfg = ExperimentConfig(**base, faults=FaultConfig(**EVENT_FAULTS))
    texp = FederatedExperiment(tcfg, DriftAttack(1.0), datasets[1],
                               device="cpu")
    with RunLogger(tcfg, None, tcfg.log_dir, jsonl_name="p") as logger:
        out = texp.run(logger)
    got = _fault_events(logger.jsonl_path)
    for e in got:
        jax_validate_event(e)
        assert e["v"] >= 13
    rows = F.hier_fault_schedule(texp._fault_key, 0, tcfg.epochs,
                                 texp._placement, texp.faults)
    acts = F.plan_tier2_actions([r["shards_alive"] for r in rows],
                                texp._tier2_name, texp._tier2_f)
    want = [{**r, "tier2_action": int(a)} for r, a in zip(rows, acts)]
    strip = [{k: v for k, v in e.items() if k not in ("kind", "v", "t")}
             for e in got]
    assert strip == want
    assert out["faults"] == want
    jcfg = JConfig(**dict(base, log_dir=str(tmp_path / "j")),
                   aggregation_impl="xla",
                   faults=JFaultConfig(**EVENT_FAULTS))
    jexp = JExperiment(jcfg, attacker=JDrift(1.0), dataset=datasets[0])
    with JRunLogger(jcfg, None, jcfg.log_dir, jsonl_name="j") as jlog:
        jexp.run(jlog)
    jstrip = [{k: v for k, v in e.items() if k not in ("kind", "v", "t")}
              for e in _fault_events(jlog.jsonl_path)]
    assert strip == jstrip


RING = dict(straggler=0.3, straggler_delay=2, dropout=0.1)
RING_KW = dict(defense="Median", tier2_defense="TrimmedMean")


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory, datasets):
    """The JAX engine's uninterrupted six hierarchical rounds with
    stragglers, and its own checkpoint after round 2 (ring included)."""
    d = tmp_path_factory.mktemp("hierjax")
    jcfg = JConfig(**_base(**RING_KW), aggregation_impl="xla",
                   faults=JFaultConfig(**RING), run_dir=str(d))
    jexp = JExperiment(jcfg, attacker=JDrift(1.0), dataset=datasets[0])
    w0 = jax.tree.map(np.asarray, jexp.flat.unravel(jexp.state.weights))
    for t in range(6):
        jexp.run_round(t)
        if t == 2:
            path = JCheckpointer(jcfg).save_auto(
                jexp.state, extra=jexp.carry_state_host())
    return dict(cfg=jcfg, w0=w0, path=path,
                weights=np.array(jexp.state.weights, copy=True),
                velocity=np.array(jexp.state.velocity, copy=True))


def _port(datasets, w0=None):
    texp = FederatedExperiment(
        ExperimentConfig(**_base(**RING_KW), faults=FaultConfig(**RING)),
        DriftAttack(1.0), datasets[1], device="cpu")
    if w0 is not None:
        texp.state = init_server_state(from_jax_params(w0))
    return texp


def test_jax_ring_checkpoint_resumes_in_the_port(jax_run, datasets):
    texp = _port(datasets)
    state, extra = Checkpointer(texp.cfg, run_dir=os.path.dirname(
        jax_run["path"])).resume(jax_run["path"], with_extra=True,
                                 device="cpu")
    assert state.round == 3 and set(extra) == {"stale"}
    assert extra["stale"].shape == (2, N // M, M, texp.flat.dim)
    texp.state = state
    texp.restore_carry_state(extra)
    for t in range(3, 6):
        texp.run_round(t)
    assert rel_l2(texp.state.weights.numpy(), jax_run["weights"]) <= REL_L2
    assert rel_l2(texp.state.velocity.numpy(),
                  jax_run["velocity"]) <= REL_L2


def test_port_ring_checkpoint_resumes_in_jax(jax_run, datasets, tmp_path):
    texp = _port(datasets, jax_run["w0"])
    for t in range(3):
        texp.run_round(t)
    path = Checkpointer(texp.cfg, run_dir=str(tmp_path)).save_auto(
        texp.state, extra=texp.carry_state_host())
    jexp = JExperiment(jax_run["cfg"], attacker=JDrift(1.0),
                       dataset=datasets[0])
    state, extra = JCheckpointer(jax_run["cfg"], run_dir=str(
        tmp_path)).resume(path, with_extra=True)
    assert int(state.round) == 3
    jexp.state = state
    jexp.restore_fault_state(extra)
    for t in range(3, 6):
        jexp.run_round(t)
    assert rel_l2(np.asarray(jexp.state.weights), jax_run["weights"]) <= \
        REL_L2


def test_resumed_hierarchical_run_is_bit_equal(datasets, tmp_path):
    whole = _port(datasets)
    w0 = whole.state.weights.clone()
    for t in range(6):
        whole.run_round(t)
    first = _port(datasets)
    assert torch.equal(first.state.weights, w0)
    for t in range(3):
        first.run_round(t)
    ck = Checkpointer(first.cfg, run_dir=str(tmp_path))
    path = ck.save_auto(first.state, extra=first.carry_state_host())
    second = _port(datasets)
    second.state, extra = ck.resume(path, with_extra=True, device="cpu")
    second.restore_carry_state(extra)
    for t in range(3, 6):
        second.run_round(t)
    assert torch.equal(second.state.weights, whole.state.weights)
    assert torch.equal(second.state.velocity, whole.state.velocity)
    assert torch.equal(second.fault_state["stale"],
                       whole.fault_state["stale"])


def test_restore_refuses_another_ring(datasets):
    texp = _port(datasets)
    with pytest.raises(ValueError, match=r"\(straggler_delay, S, m, d\)"):
        texp.restore_carry_state(
            {"stale": np.zeros((2, N, texp.flat.dim), np.float32)})


# ---------------------------------------------------------------------------
# support checks and the CLI

@pytest.mark.parametrize("kw", [
    dict(aggregation="hierarchical", megabatch=4,
         faults=dict(shard_dropout=0.2)),
    dict(aggregation="flat", faults=dict(shard_dropout=0.2)),
    dict(aggregation="hierarchical", megabatch=4, mesh_shape=(2, 1),
         faults=dict(straggler=0.2)),
    dict(aggregation="hierarchical", megabatch=4, mesh_shape=(1, 2),
         faults=dict(straggler=0.2)),
], ids=["shard-hier", "shard-flat", "straggler-spmd", "straggler-1-col"])
def test_check_fault_support_is_jax_s(kw):
    faults = JFaultConfig(**kw.pop("faults"))
    jcfg = JConfig(users_count=16, mal_prop=0.25, defense="Krum",
                   faults=faults, **kw)
    try:
        JF.check_fault_support(jcfg)
    except ValueError as e:
        with pytest.raises(ValueError) as te:
            F.check_fault_support(jcfg, jcfg.participation)
        assert str(te.value) == str(e)
    else:
        F.check_fault_support(jcfg, jcfg.participation)


def test_cli_runs_a_faulted_hierarchical_round(tmp_path, capsys):
    out = cli.main(["-s", C.SYNTH_MNIST, "-d", "TrimmedMean", "-n", "20",
                    "-m", "0.2", "-e", "3", "-c", "16", "--aggregation",
                    "hierarchical", "--megabatch", "5", "--tier2-defense",
                    "Median", "--fault-shard-dropout", "0.3",
                    "--fault-shard-dropout-dwell", "2", "--fault-dropout",
                    "0.1", "--synth-train", "400", "--synth-test", "100",
                    "--log-dir", str(tmp_path / "logs"), "--run-dir",
                    str(tmp_path / "runs"), "--device", "cpu"])
    capsys.readouterr()
    assert [r["round"] for r in out["faults"]] == [0, 1, 2]
    assert all(len(r["shard_alive"]) == 4 for r in out["faults"])
