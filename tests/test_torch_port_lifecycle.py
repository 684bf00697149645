"""The port's run lifecycle (utils/lifecycle.py, the engine's run() and
the CLI) against the JAX package's.

The JAX package's tests/test_lifecycle.py case by case on the port
(journal, manifest, run ids, graceful shutdown, preempt -> resume
exactly once, schema v3 rules, failure taxonomy), then:

- a journaled port run read by the JAX package's own readers:
  ``validate_event``, ``tools/check_events.py``, ``RunJournal.verify``
  and ``RunRegistry.resolve``;
- ``FL_PREEMPT_AT_ROUND=k`` stops both engines at the same boundary;
- the watchdog rolls back to the last auto-checkpoint, as the JAX
  engine does on the same config;
- the CLI: the lifecycle flags and the two knob flags are JAX's; a CPU
  subprocess exits 75 on the injected preempt and 0 on ``--resume``; a
  divergence exits 76.
"""

import importlib.util
import json
import os
import signal
import subprocess
import sys
import threading

import pytest
import torch

from attacking_federate_learning_tpu import cli as jax_cli
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
from attacking_federate_learning_tpu.utils import lifecycle as jlifecycle
from attacking_federate_learning_tpu.utils import metrics as jmetrics
from attacking_federate_learning_tpu.utils.checkpoint import (
    Checkpointer as JCheckpointer
)
from attacking_federate_learning_tpu.utils.registry import (
    RunRegistry as JRegistry
)
from attacking_federate_learning_tpu_torch import cli
from attacking_federate_learning_tpu_torch import config as C
from attacking_federate_learning_tpu_torch.attacks import DriftAttack
from attacking_federate_learning_tpu_torch.config import (
    ExperimentConfig, FaultConfig
)
from attacking_federate_learning_tpu_torch.core import faults as F
from attacking_federate_learning_tpu_torch.core.engine import (
    FederatedExperiment
)
from attacking_federate_learning_tpu_torch.data.datasets import load_dataset
from attacking_federate_learning_tpu_torch.utils.checkpoint import (
    Checkpointer
)
from attacking_federate_learning_tpu_torch.utils.lifecycle import (
    EXIT_DIVERGED, EXIT_OK, EXIT_PREEMPTED, GracefulShutdown, Preempted,
    RunJournal, classify_failure, run_id_for
)
from attacking_federate_learning_tpu_torch.utils.metrics import (
    RunLogger, iter_events, validate_event
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = dict(synth_train=256, synth_test=64)


def _cfg(tmp_path, **kw):
    kw.setdefault("dataset", C.SYNTH_MNIST)
    kw.setdefault("users_count", 10)
    kw.setdefault("mal_prop", 0.2)
    kw.setdefault("batch_size", 16)
    kw.setdefault("epochs", 10)
    kw.setdefault("test_step", 5)
    kw.setdefault("log_dir", str(tmp_path / "logs"))
    kw.setdefault("run_dir", str(tmp_path / "runs"))
    return ExperimentConfig(**SIZES, **kw)


def _engine(cfg):
    ds = load_dataset(cfg.dataset, seed=0, **SIZES)
    return FederatedExperiment(cfg, DriftAttack(1.0), ds, device="cpu")


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _load_tool(name):
    path = os.path.join(ROOT, "tools", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# the journal

def test_journal_exactly_once_and_replay(tmp_path):
    j = RunJournal(str(tmp_path), "r1")
    assert j.start_attempt(0) == 1
    j.commit_rounds(0, 3)
    j.commit_eval(0)
    j.commit_rounds(0, 3)          # re-execution below the mark: no-op
    j.commit_rounds(2, 5)          # clamped to [4, 5]
    j.commit_eval(0)
    j.commit_eval(5)
    j.finish("done")
    j.close()
    j2 = RunJournal(str(tmp_path), "r1")
    assert j2.high == 5 and j2.evals == {0, 5} and j2.attempt == 1
    assert not j2.fresh_round(5) and j2.fresh_round(6)
    assert not j2.fresh_eval(5) and j2.fresh_eval(9)
    assert j2.verify(epochs=6) == []
    problems = j2.verify(epochs=8, test_step=5)
    assert any("never committed" in p for p in problems)
    assert any("eval set mismatch" in p for p in problems)
    # The JAX package's journal reads the port's file the same way.
    jj = jlifecycle.RunJournal(str(tmp_path), "r1")
    assert (jj.high, jj.evals, jj.attempt) == (5, {0, 5}, 1)
    assert jj.verify(epochs=8, test_step=5) == problems


def test_journal_duplicate_detection_from_raw_file(tmp_path):
    d = tmp_path / "dup"
    os.makedirs(d)
    with open(d / "journal.jsonl", "w") as f:
        f.write(json.dumps({"kind": "rounds", "start": 0, "end": 2}) + "\n")
        f.write(json.dumps({"kind": "rounds", "start": 2, "end": 3}) + "\n")
        f.write(json.dumps({"kind": "eval", "round": 0}) + "\n")
        f.write(json.dumps({"kind": "eval", "round": 0}) + "\n")
    problems = RunJournal(str(tmp_path), "dup").verify(epochs=4)
    assert any("more than once: [2]" in p for p in problems)
    assert any("evals committed more than once: [0]" in p for p in problems)


def test_journal_torn_line_sealed_and_skipped(tmp_path):
    d = tmp_path / "torn"
    os.makedirs(d)
    with open(d / "journal.jsonl", "w") as f:
        f.write(json.dumps({"kind": "rounds", "start": 0, "end": 4}) + "\n")
        f.write('{"kind": "rounds", "start": 5, "e')     # torn mid-write
    j = RunJournal(str(tmp_path), "torn")
    assert j.high == 4 and j.torn_lines == 1
    j.commit_rounds(5, 7)
    j.close()
    j2 = RunJournal(str(tmp_path), "torn")
    assert j2.high == 7 and j2.verify(epochs=8) == []


def test_manifest_status_transitions(tmp_path):
    j = RunJournal(str(tmp_path), "m")
    j.start_attempt(0)
    assert j.read_manifest()["status"] == "running"
    j.commit_rounds(0, 9)
    j.finish("preempted", EXIT_PREEMPTED, checkpoint="x.npz")
    man = j.read_manifest()
    assert man["status"] == "preempted" and man["exit_code"] == 75
    assert man["last_round"] == 9 and man["rounds_committed"] == 10
    j.close()
    j2 = RunJournal(str(tmp_path), "m")
    assert j2.start_attempt(10) == 2
    assert j2.read_manifest()["attempt"] == 2


def test_run_id_identity(tmp_path):
    """Stable across io-only differences, distinct across anything that
    shapes the trajectory; a hash of the port's own config."""
    a = _cfg(tmp_path)
    b = _cfg(tmp_path, log_dir=str(tmp_path / "elsewhere"),
             run_dir=str(tmp_path / "other"), output="tee.txt")
    assert run_id_for(a) == run_id_for(b)
    assert run_id_for(a) != run_id_for(_cfg(tmp_path, seed=1))
    assert run_id_for(a) != run_id_for(_cfg(tmp_path, defense="Krum"))
    assert run_id_for(a).startswith("SYNTH_MNIST_NoDefense_s0_")
    assert (jlifecycle._IDENTITY_EXCLUDED
            == ("output", "log_dir", "run_dir"))


def test_exit_codes_and_taxonomy_are_jax_s():
    assert (EXIT_OK, EXIT_PREEMPTED, EXIT_DIVERGED) == (0, 75, 76)
    assert classify_failure(EXIT_OK) == "done"
    assert classify_failure(EXIT_PREEMPTED) == "preempted"
    assert classify_failure(EXIT_DIVERGED) == "divergence"
    assert classify_failure(1, "RESOURCE_EXHAUSTED: out of memory") == "oom"
    assert classify_failure(1, "torch.OutOfMemoryError: CUDA out of "
                               "memory") == "oom"
    assert classify_failure(-9, "std::bad_alloc") == "oom"
    assert classify_failure(1, "Unable to initialize backend") == "backend"
    assert classify_failure(
        1, "FloatingPointError: server state diverged") == "divergence"
    assert classify_failure(-9, "") == "crash"
    assert classify_failure(-15, "", stalled=True) == "stall"
    assert classify_failure(EXIT_PREEMPTED, "", stalled=True) == "stall"
    for rc, tail in ((1, "CUDA error: out of memory"), (3, "relay"),
                     (2, "exhausted"), (0, "")):
        assert classify_failure(rc, tail) == jlifecycle.classify_failure(
            rc, tail)


# ---------------------------------------------------------------------------
# graceful shutdown

def test_graceful_shutdown_flag_and_restore():
    sd = GracefulShutdown(signals=(signal.SIGUSR1,))
    before = signal.getsignal(signal.SIGUSR1)
    with sd:
        assert not sd.requested
        os.kill(os.getpid(), signal.SIGUSR1)
        assert sd.requested and sd.source == "SIGUSR1"
        assert sd.should_preempt(0, 0)
    assert signal.getsignal(signal.SIGUSR1) == before


def test_injected_preempt_fires_once_per_lifecycle():
    sd = GracefulShutdown(preempt_at_round=4)
    assert not sd.should_preempt(0, 3)
    assert sd.should_preempt(0, 4)
    assert sd.should_preempt(0, 6)
    assert sd.source == "injected"
    assert not GracefulShutdown(preempt_at_round=4).should_preempt(5, 7)


def test_threaded_sigterm_is_seen_by_main_thread():
    sd = GracefulShutdown(signals=(signal.SIGUSR2,))
    with sd:
        t = threading.Thread(
            target=lambda: os.kill(os.getpid(), signal.SIGUSR2))
        t.start()
        t.join()
        for _ in range(100):
            if sd.requested:
                break
        assert sd.requested


# ---------------------------------------------------------------------------
# the engine

def test_engine_preempt_checkpoints_then_resumes_exactly_once(tmp_path):
    cfg = _cfg(tmp_path, checkpoint_every=3)
    rid = run_id_for(cfg)
    exp = _engine(cfg)
    with RunLogger(cfg, None, cfg.log_dir, jsonl_name="lc") as logger:
        with pytest.raises(Preempted) as e:
            exp.run(logger, checkpointer=Checkpointer(cfg),
                    journal=RunJournal(cfg.run_dir, rid),
                    shutdown=GracefulShutdown(preempt_at_round=4))
    assert e.value.round == 5 and exp.state.round == 6
    man = RunJournal(cfg.run_dir, rid).read_manifest()
    assert man["status"] == "preempted" and os.path.exists(man["checkpoint"])

    resumed = _engine(cfg)
    ck2 = Checkpointer(cfg)
    state, extra = ck2.resume(ck2.latest(), with_extra=True, device="cpu")
    resumed.state = state
    resumed.restore_fault_state(extra)
    with RunLogger(cfg, None, cfg.log_dir, jsonl_name="lc") as logger:
        resumed.run(logger, checkpointer=ck2,
                    journal=RunJournal(cfg.run_dir, rid),
                    shutdown=GracefulShutdown(preempt_at_round=4))
    final = RunJournal(cfg.run_dir, rid)
    assert final.verify(epochs=cfg.epochs, test_step=cfg.test_step) == []
    assert final.read_manifest()["status"] == "done"
    events = _events(os.path.join(cfg.log_dir, "lc.jsonl"))
    for ev in events:
        validate_event(ev)
    evals = [ev["round"] for ev in events if ev["kind"] == "eval"]
    assert sorted(evals) == [0, 5, 9] and len(set(evals)) == len(evals)
    phases = [ev["phase"] for ev in events if ev["kind"] == "lifecycle"]
    assert phases == ["start", "preempt", "resume", "complete"]


def test_engine_real_sigterm_preempts_at_first_boundary(tmp_path):
    cfg = _cfg(tmp_path, epochs=6, checkpoint_every=2)
    exp = _engine(cfg)
    sd = GracefulShutdown(signals=(signal.SIGTERM,))
    with sd:
        # Delivered before the loop: honored at the first boundary.
        os.kill(os.getpid(), signal.SIGTERM)
        with RunLogger(cfg, None, cfg.log_dir, jsonl_name="sig") as logger:
            with pytest.raises(Preempted) as ei:
                exp.run(logger, checkpointer=Checkpointer(cfg),
                        journal=RunJournal(cfg.run_dir, "sig"),
                        shutdown=sd)
    assert ei.value.source == "SIGTERM" and ei.value.round == 0
    assert exp.state.round == 1
    assert RunJournal(cfg.run_dir, "sig").read_manifest()[
        "status"] == "preempted"


def test_preempt_without_checkpointer_still_checkpoints(tmp_path):
    cfg = _cfg(tmp_path, epochs=6)
    exp = _engine(cfg)
    with pytest.raises(Preempted):
        exp.run(log=lambda s: None,
                shutdown=GracefulShutdown(preempt_at_round=2))
    autos = [n for n in os.listdir(os.path.join(cfg.run_dir, cfg.dataset))
             if n.startswith("checkpoint-auto-")]
    # The first boundary at or past round 2 is round 5's.
    assert sorted(autos) == ["checkpoint-auto-00000006.json",
                             "checkpoint-auto-00000006.npz"]


def test_exactly_once_faulted_replay_suppression(tmp_path):
    """Per-round 'fault' events once each across a preempt and resume,
    and the same counts as the uninterrupted run's."""
    fc = FaultConfig(dropout=0.2, straggler=0.15)
    cfg = _cfg(tmp_path, users_count=12, epochs=8, test_step=4,
               defense="TrimmedMean", faults=fc, checkpoint_every=3)
    rid = "faulted_once"
    ck = Checkpointer(cfg)
    with RunLogger(cfg, None, cfg.log_dir, jsonl_name="f1") as logger:
        with pytest.raises(Preempted):
            _engine(cfg).run(logger, checkpointer=ck,
                             journal=RunJournal(cfg.run_dir, rid),
                             shutdown=GracefulShutdown(preempt_at_round=4))
    resumed = _engine(cfg)
    state, extra = ck.resume(ck.latest(), with_extra=True, device="cpu")
    resumed.state = state
    resumed.restore_fault_state(extra)
    with RunLogger(cfg, None, cfg.log_dir, jsonl_name="f1") as logger:
        resumed.run(logger, checkpointer=ck,
                    journal=RunJournal(cfg.run_dir, rid),
                    shutdown=GracefulShutdown(preempt_at_round=4))
    events = _events(os.path.join(cfg.log_dir, "f1.jsonl"))
    faults = [ev for ev in events if ev["kind"] == "fault"]
    assert [ev["round"] for ev in faults] == list(range(8))
    want = _engine(cfg).run(log=lambda s: None)["faults"]
    keys = ("round", "injected_dropout", "injected_straggler",
            "injected_corrupt", "quarantined")
    assert [{k: ev[k] for k in keys} for ev in faults] == want
    assert RunJournal(cfg.run_dir, rid).verify(epochs=8, test_step=4) == []


def test_v3_lifecycle_schema_rules():
    validate_event({"kind": "lifecycle", "phase": "preempt", "v": 3})
    validate_event({"kind": "lifecycle", "phase": "retry", "round": 4,
                    "attempt": 2, "v": 3})
    validate_event({"kind": "round", "round": 1, "v": 1})
    validate_event({"kind": "heartbeat", "rss_mb": 1.0,
                    "last_event_age_s": 0.0, "v": 2})
    with pytest.raises(ValueError, match="need schema v3"):
        validate_event({"kind": "lifecycle", "phase": "x", "v": 2})
    with pytest.raises(ValueError, match="missing required"):
        validate_event({"kind": "lifecycle", "v": 3})


# ---------------------------------------------------------------------------
# the JAX package's readers on a port run

def test_port_run_passes_the_jax_readers(tmp_path):
    """A journaled, faulted, preempted and resumed port run: every line
    of its log passes the JAX package's validate_event, iter_events and
    tools/check_events.py; its journal passes the JAX RunJournal's
    verify; the JAX RunRegistry resolves it, and its report summary
    reads the port's eval and fault events."""
    from attacking_federate_learning_tpu import report

    fc = FaultConfig(dropout=0.1, straggler=0.2, corrupt=0.1)
    cfg = _cfg(tmp_path, defense="Krum", faults=fc, checkpoint_every=3,
               epochs=9, test_step=4)
    for attempt in range(2):
        exp = _engine(cfg)
        ck = Checkpointer(cfg, auto_dir=os.path.join(cfg.run_dir, "rd"))
        if attempt:
            state, extra = ck.resume(ck.latest(), with_extra=True,
                                     device="cpu")
            exp.state = state
            exp.restore_carry_state(extra)
        with RunLogger(cfg, None, cfg.log_dir, jsonl_name="rd",
                       heartbeat_every=0.01) as logger:
            try:
                exp.run(logger, checkpointer=ck,
                        journal=RunJournal(cfg.run_dir, "rd"),
                        shutdown=GracefulShutdown(preempt_at_round=2))
            except Preempted:
                assert attempt == 0
    path = os.path.join(cfg.log_dir, "rd.jsonl")
    events = list(jmetrics.iter_events(path))
    assert events == list(iter_events(path))
    for ev in events:
        jmetrics.validate_event(ev)
    kinds = {ev["kind"] for ev in events}
    assert {"eval", "fault", "lifecycle", "registry"} <= kinds
    assert _load_tool("check_events").main([path]) == 0
    journal = jlifecycle.RunJournal(cfg.run_dir, "rd")
    assert journal.verify(epochs=9, test_step=4) == []
    assert journal.read_manifest()["status"] == "done"
    entry = JRegistry(cfg.run_dir).resolve("rd")
    assert entry["status"] == "done" and entry["attempts"] == 2
    assert entry["fault_rounds"] == 9 and entry["journal_high"] == 8
    summary = report.summarize_run(events)
    assert summary["accuracy"]["trajectory"][-1][0] == 8


@pytest.mark.parametrize("k,test_step,every,epochs", [
    (4, 5, 3, 10), (7, 5, 0, 12), (8, 5, 5, 21)])
def test_preempt_at_round_stops_both_engines_at_one_boundary(
        k, test_step, every, epochs, tmp_path):
    """FL_PREEMPT_AT_ROUND=k (GracefulShutdown(preempt_at_round=k)):
    the JAX engine's span boundaries and the port's host boundaries
    agree, so both stop after the same round and checkpoint the same
    round counter."""
    kw = dict(dataset=C.SYNTH_MNIST, users_count=6, mal_prop=0.2,
              batch_size=8, epochs=epochs, test_step=test_step,
              checkpoint_every=every, synth_train=120, synth_test=30)
    tcfg = ExperimentConfig(**kw, run_dir=str(tmp_path / "t"))
    jcfg = JConfig(**kw, run_dir=str(tmp_path / "j"),
                   log_dir=str(tmp_path / "logs"))
    texp = FederatedExperiment(
        tcfg, DriftAttack(1.0),
        load_dataset(tcfg.dataset, seed=0, synth_train=120, synth_test=30),
        device="cpu")
    jexp = JExperiment(jcfg, attacker=JDrift(1.0), dataset=jax_load_dataset(
        jcfg.dataset, seed=0, synth_train=120, synth_test=30))
    with pytest.raises(Preempted) as te:
        texp.run(log=lambda s: None,
                 shutdown=GracefulShutdown(preempt_at_round=k))
    with jmetrics.RunLogger(jcfg, None, jcfg.log_dir) as logger:
        with pytest.raises(jlifecycle.Preempted) as je:
            jexp.run(logger, shutdown=jlifecycle.GracefulShutdown(
                preempt_at_round=k))
    assert te.value.round == je.value.round >= k
    assert texp.state.round == int(jexp.state.round) == te.value.round + 1
    boundaries = [t for t in range(epochs) if t % test_step == 0
                  or t == epochs - 1 or (every and t % every == 0)]
    assert te.value.round == min(t for t in boundaries if t >= k)


# ---------------------------------------------------------------------------
# the watchdog with checkpoints

# n = 10, f = 0: with this fault seed the scale corruption hits round 5
# alone, so the boundary of round 4 saves a good state first.
WATCHDOG = dict(corrupt=0.02, corrupt_mode="scale", corrupt_scale=1e30,
                watchdog_norm=1e6, max_rollbacks=1, seed=2)


def test_watchdog_rolls_back_to_the_last_auto_checkpoint(tmp_path):
    """Divergence after round 5 is seen at the boundary of round 6; the
    watchdog restores the auto-checkpointed state of round 4's boundary
    (round counter 5), writes it again as the on-failure checkpoint,
    and past max_rollbacks raises FloatingPointError with that state
    restored.  The JAX engine, on the same config, prints the same
    lines and keeps the same checkpoints."""
    kw = dict(dataset=C.SYNTH_MNIST, users_count=10, mal_prop=0.0,
              batch_size=16, epochs=8, test_step=2, checkpoint_every=2,
              defense="NoDefense", **SIZES)
    fc = FaultConfig(**WATCHDOG)
    tcfg = ExperimentConfig(**kw, faults=fc, run_dir=str(tmp_path / "t"))
    key = F.fault_key(tcfg)
    assert [t for t in range(8)
            if F.fault_masks(key, t, 10, 0, fc)[2].any()] == [5]
    texp = _engine(tcfg)
    ck = Checkpointer(tcfg)
    saves = []
    inner = ck.save_auto

    def spy(state, extra=None):
        saves.append(int(state.round))
        return inner(state, extra)

    ck.save_auto = spy
    lines = []
    with pytest.raises(FloatingPointError, match="exhausted 1 rollbacks"):
        texp.run(checkpointer=ck, log=lines.append)
    # Periodic saves at the boundaries of rounds 0, 2 and 4, then one
    # on-failure save per rollback, each of round counter 5.
    assert saves == [1, 3, 5, 5, 5]
    assert texp.state.round == 5
    assert bool(torch.isfinite(texp.state.weights).all())
    restored = ck.resume(ck.latest(), device="cpu")
    assert restored.round == 5
    assert torch.equal(restored.weights, texp.state.weights)
    rollbacks = [s for s in lines if s.startswith("!! server state")]
    assert rollbacks == [
        "!! server state diverged after round 6; rolling back to round 5 "
        f"(rollback {i}/1)" for i in (1, 2)]

    jcfg = JConfig(**kw, faults=JFaultConfig(**WATCHDOG),
                   run_dir=str(tmp_path / "j"),
                   log_dir=str(tmp_path / "jlogs"),
                   output=str(tmp_path / "jax.txt"))
    jexp = JExperiment(jcfg, attacker=JDrift(0.0), dataset=jax_load_dataset(
        jcfg.dataset, seed=0, **SIZES))
    jck = JCheckpointer(jcfg)
    with jmetrics.RunLogger(jcfg, jcfg.output, jcfg.log_dir) as logger:
        with pytest.raises(FloatingPointError, match="exhausted"):
            jexp.run(logger, checkpointer=jck)
    with open(jcfg.output) as f:
        jlines = [s.rstrip("\n") for s in f
                  if s.startswith("!! server state")]
    assert jlines == rollbacks
    assert int(jexp.state.round) == 5
    assert (sorted(os.listdir(jck.dir))
            == sorted(os.listdir(ck.dir)))


# ---------------------------------------------------------------------------
# the CLI

_LIFECYCLE_FLAGS = ("output", "log_dir", "run_dir", "no_checkpoint",
                    "resume", "checkpoint_every", "heartbeat", "journal",
                    "run_id", "krum_paper_scoring", "remat")


def _flags(parser):
    return {a.dest: (a.option_strings, a.default, a.const, a.nargs,
                     a.metavar, a.type, a.help)
            for a in parser._actions if a.dest in _LIFECYCLE_FLAGS}


def test_cli_lifecycle_and_knob_flags_are_jax_s():
    got = _flags(cli.build_parser())
    assert sorted(got) == sorted(_LIFECYCLE_FLAGS)
    assert got == _flags(jax_cli.build_parser())


@pytest.mark.parametrize("argv", [
    [], ["-o", "x.txt", "--log-dir", "l", "--run-dir", "r",
         "--checkpoint-every", "5"],
    ["-d", "Krum", "--krum-paper-scoring"],
    ["-d", "Bulyan", "--krum-paper-scoring", "-n", "20", "-m", "0.2"]])
def test_cli_builds_jax_s_lifecycle_config(argv):
    got = cli.config_from_args(cli.build_parser().parse_args(argv))
    want = jax_cli.config_from_args(jax_cli.build_parser().parse_args(argv))
    for name in ("checkpoint_every", "checkpoint_acc_threshold", "output",
                 "log_dir", "run_dir", "krum_paper_scoring", "defense"):
        assert getattr(got, name) == getattr(want, name), name


def test_cli_remat_runs_to_the_weights_of_the_run_without(tmp_path):
    """``--remat`` reaches the client step, whose recompute repeats the
    forward's calls: the run's final weights are the plain run's."""
    argv = ["-s", C.SYNTH_MNIST_HARD, "-n", "7", "-e", "2", "-d", "Krum",
            "-c", "16", "--synth-train", "256", "--synth-test", "64",
            "--device", "cpu"]
    plain = cli.main(argv + ["--log-dir", str(tmp_path / "a"),
                             "--run-dir", str(tmp_path / "a")])
    remat = cli.main(argv + ["--remat", "--log-dir", str(tmp_path / "b"),
                             "--run-dir", str(tmp_path / "b")])
    assert torch.equal(remat["final_weights"], plain["final_weights"])


def _cli_argv(tmp_path, *extra):
    return ["-s", C.SYNTH_MNIST, "-n", "6", "-m", "0.2", "-e", "9", "-c",
            "8", "--synth-train", "120", "--synth-test", "30",
            "--checkpoint-every", "3", "--run-id", "cli",
            "--log-dir", str(tmp_path / "logs"),
            "--run-dir", str(tmp_path / "runs"), "--device", "cpu", *extra]


def test_cli_subprocess_exits_75_then_resumes_to_0(tmp_path):
    """The injected preempt (FL_PREEMPT_AT_ROUND=4: the boundary of round
    5) exits 75; ``--resume`` continues from the checkpoint and exits 0;
    the journal verifies and the events pass the JAX package's
    validator."""
    env = {**os.environ, "PYTHONPATH": ROOT, "FL_PREEMPT_AT_ROUND": "4"}
    cmd = [sys.executable, "-m", "attacking_federate_learning_tpu_torch.cli"]
    first = subprocess.run(cmd + _cli_argv(tmp_path), env=env, cwd=ROOT,
                           capture_output=True, text=True, timeout=240)
    assert first.returncode == EXIT_PREEMPTED, first.stderr[-2000:]
    assert "!! preempted (injected) after round 5" in first.stdout
    second = subprocess.run(cmd + _cli_argv(tmp_path, "--resume"), env=env,
                            cwd=ROOT, capture_output=True, text=True,
                            timeout=240)
    assert second.returncode == EXIT_OK, second.stderr[-2000:]
    assert "Resumed from round 6" in second.stdout
    journal = jlifecycle.RunJournal(str(tmp_path / "runs"), "cli")
    assert journal.verify(epochs=9, test_step=5) == []
    assert journal.read_manifest()["status"] == "done"
    events = list(jmetrics.iter_events(tmp_path / "logs" / "cli.jsonl"))
    assert [ev["round"] for ev in events if ev["kind"] == "eval"] == [0, 5,
                                                                       8]


def test_cli_divergence_exits_76(tmp_path, capsys):
    """The watchdog's rollbacks exhausted: a 'fatal' lifecycle event,
    the manifest 'diverged', exit 76."""
    argv = _cli_argv(tmp_path, "--fault-corrupt", "0.3",
                     "--fault-corrupt-mode", "scale", "-m", "0.0")
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code == EXIT_DIVERGED
    assert "[lifecycle] fatal (divergence)" in capsys.readouterr().out
    man = RunJournal(str(tmp_path / "runs"), "cli").read_manifest()
    assert man["status"] == "diverged" and man["exit_code"] == 76
    events = _events(tmp_path / "logs" / "cli.jsonl")
    assert events[-1]["kind"] == "lifecycle"
    assert events[-1]["phase"] == "fatal"
    assert sum(ev.get("rolled_back", 0) for ev in events) == 4
