"""The port's run metrics (utils/metrics.py) and registry writer
(utils/registry.py) against the JAX package's.

The JAX package's tests/test_metrics.py case by case on the port's
RunLogger (tee, CSV schema, JSONL records, context manager, heartbeat),
then the schema tables and ``validate_event`` against the JAX package's
on the same events, the files-off RunLogger that ``run(log=...)`` uses,
and the index entry of a finished run against the JAX registry's.
"""

import json
import os
import time

import numpy as np
import pytest

from attacking_federate_learning_tpu.config import (
    ExperimentConfig as JConfig
)
from attacking_federate_learning_tpu.utils import metrics as jmetrics
from attacking_federate_learning_tpu.utils.registry import (
    RunRegistry as JRegistry
)
from attacking_federate_learning_tpu_torch import config as C
from attacking_federate_learning_tpu_torch.attacks import DriftAttack
from attacking_federate_learning_tpu_torch.config import ExperimentConfig
from attacking_federate_learning_tpu_torch.core.engine import (
    FederatedExperiment
)
from attacking_federate_learning_tpu_torch.data.datasets import load_dataset
from attacking_federate_learning_tpu_torch.utils import metrics
from attacking_federate_learning_tpu_torch.utils.lifecycle import RunJournal
from attacking_federate_learning_tpu_torch.utils.metrics import (
    RunLogger, SCHEMA_VERSION, iter_events, validate_event
)
from attacking_federate_learning_tpu_torch.utils.registry import RunRegistry


def make_cfg(tmp_path, **kw):
    kw.setdefault("dataset", C.SYNTH_MNIST)
    kw.setdefault("log_dir", str(tmp_path))
    return ExperimentConfig(**kw)


def test_tee_to_output_file(tmp_path):
    """Reference my_print semantics (main.py:13-18): with --output, lines
    append to the file instead of stdout."""
    out = tmp_path / "run.log"
    cfg = make_cfg(tmp_path, output=str(out))
    logger = RunLogger(cfg, cfg.output, cfg.log_dir)
    logger.print("hello")
    logger.print("no newline", end="")
    assert out.read_text() == "hello\nno newline"


def test_record_eval_and_csv_schema(tmp_path):
    cfg = make_cfg(tmp_path, defense="Krum", num_std=1.5, mal_prop=0.24)
    logger = RunLogger(cfg, None, cfg.log_dir)
    acc = logger.record_eval(epoch=5, test_loss=0.01, correct=1800,
                             test_size=2000)
    assert np.isclose(acc, 90.0)
    logger.record_eval(epoch=10, test_loss=0.005, correct=1900,
                       test_size=2000)
    logger.finish()
    csv = os.path.join(cfg.log_dir, cfg.csv_name())
    np.testing.assert_allclose(np.loadtxt(csv, delimiter=","), [90.0, 95.0])
    assert "Krum" in os.path.basename(csv)
    assert "stdev_1.5" in os.path.basename(csv)
    with open(logger.jsonl_path) as f:
        kinds = [json.loads(x)["kind"] for x in f]
    assert kinds.count("eval") == 2


@pytest.mark.parametrize("kw", [
    {}, dict(defense="Krum", num_std=1.5, mal_prop=0.24),
    dict(dataset=C.SYNTH_CIFAR10, backdoor="pattern", users_count=100,
         learning_rate=0.05, alpha=2.0),
    dict(backdoor="2", num_std="auto", users_count=19, mal_prop=0.21)])
def test_csv_name_is_jax_s(kw):
    """The reference filename schema (main.py:100), name for name."""
    assert ExperimentConfig(**kw).csv_name() == JConfig(**kw).csv_name()


def test_tee_handle_opened_once(tmp_path):
    out = tmp_path / "tee.log"
    cfg = make_cfg(tmp_path, output=str(out))
    logger = RunLogger(cfg, cfg.output, cfg.log_dir)
    handle = logger._tee
    logger.print("one")
    logger.print("two")
    assert logger._tee is handle
    logger.finish()
    assert not handle.closed              # tee survives finish()
    logger.print("after finish")
    logger.close()
    assert handle.closed
    assert out.read_text() == "one\ntwo\nafter finish\n"


def test_runlogger_context_manager_crash_safe(tmp_path):
    cfg = make_cfg(tmp_path, defense="Median")
    with pytest.raises(RuntimeError, match="boom"):
        with RunLogger(cfg, None, cfg.log_dir) as logger:
            logger.record_eval(epoch=0, test_loss=0.5, correct=1000,
                               test_size=2000)
            raise RuntimeError("boom")
    assert logger._jsonl.closed
    csv = os.path.join(cfg.log_dir, cfg.csv_name())
    np.testing.assert_allclose(np.loadtxt(csv, delimiter=","), 50.0)
    logger.close()                        # idempotent


def test_event_schema_validation():
    validate_event({"kind": "round", "round": 3})
    validate_event({"kind": "eval", "round": 0, "test_loss": 0.1,
                    "accuracy": 50.0, "correct": 1, "test_size": 2})
    with pytest.raises(ValueError, match="unknown event kind"):
        validate_event({"kind": "nope"})
    with pytest.raises(ValueError, match="missing required"):
        validate_event({"kind": "asr", "round": 1})
    with pytest.raises(ValueError, match="schema version"):
        validate_event({"kind": "round", "round": 1, "v": 99})
    with pytest.raises(ValueError, match="must be numeric"):
        validate_event({"kind": "round", "round": "three"})


def test_record_stamps_version_and_iter_events_roundtrip(tmp_path):
    cfg = make_cfg(tmp_path)
    with RunLogger(cfg, None, cfg.log_dir, jsonl_name="rt") as logger:
        logger.record(kind="round", round=0, extra_field=1.5)
        logger.record(freeform="no kind, no validation")
        path = logger.jsonl_path
    recs = list(iter_events(path, validate=False))
    assert recs[0]["v"] == SCHEMA_VERSION and recs[0]["extra_field"] == 1.5
    assert "v" not in recs[1]
    with pytest.raises(ValueError, match="unknown event kind"):
        list(iter_events(path))
    bad = []
    assert len(list(iter_events(path, skip_bad=True, bad_lines=bad))) == 1
    assert bad[0][0] == 2


def test_heartbeat_thread_emits_and_stops(tmp_path):
    cfg = make_cfg(tmp_path)
    with RunLogger(cfg, None, str(tmp_path), jsonl_name="hb",
                   heartbeat_every=0.05) as logger:
        logger.record(kind="round", round=0)
        time.sleep(0.18)
        logger.record(kind="round", round=3)
        time.sleep(0.12)
        path = logger.jsonl_path
    time.sleep(0.15)
    with open(path) as f:
        evs = [json.loads(line) for line in f]
    beats = [e for e in evs if e["kind"] == "heartbeat"]
    assert len(beats) >= 3
    for e in beats:
        validate_event(e)
        jmetrics.validate_event(e)
        assert e["rss_mb"] > 0 and e["last_event_age_s"] >= 0
    assert beats[-1]["round"] == 3
    assert any("rounds_per_s" in e for e in beats)
    # A beat never resets the stall clock.
    stall = [e["last_event_age_s"] for e in beats if e["t"] < 0.18]
    assert stall == sorted(stall)
    with pytest.raises(ValueError, match="finish"):
        logger.record(kind="round", round=4)


def test_heartbeat_off_by_default(tmp_path):
    cfg = make_cfg(tmp_path)
    with RunLogger(cfg, None, str(tmp_path), jsonl_name="nohb") as logger:
        assert logger._hb_thread is None
        logger.record(kind="round", round=0)
        path = logger.jsonl_path
    with open(path) as f:
        assert all(json.loads(line)["kind"] != "heartbeat" for line in f)


# ---------------------------------------------------------------------------
# the schema is the JAX package's

def test_schema_tables_are_jax_s():
    assert metrics.SCHEMA_VERSION == jmetrics.SCHEMA_VERSION == 14
    assert metrics.SUPPORTED_VERSIONS == jmetrics.SUPPORTED_VERSIONS
    assert metrics.EVENT_KINDS == jmetrics.EVENT_KINDS
    assert metrics.KIND_MIN_VERSION == jmetrics.KIND_MIN_VERSION


_EVENTS = [
    {"kind": "eval", "round": 0, "test_loss": 0.1, "accuracy": 50.0,
     "correct": 1, "test_size": 2},
    {"kind": "fault", "round": 3, "injected_dropout": 1, "quarantined": 1},
    {"kind": "fault", "round": 4, "rolled_back": 1, "restored_round": 3},
    {"kind": "lifecycle", "phase": "preempt", "round": 10, "v": 3},
    {"kind": "lifecycle", "phase": "x", "v": 2},
    {"kind": "registry", "run_id": "r", "rounds": 21},
    {"kind": "registry", "v": 14},
    {"kind": "heartbeat", "rss_mb": 1.0, "last_event_age_s": 0.0, "v": 1},
    {"kind": "numerics", "round": 0, "defense": "Krum", "v": 13},
    {"kind": "asr", "round": "0", "attack_success_rate": 1.0},
    {"kind": "nope"}, {"kind": "round", "round": 1, "v": 15}, [1, 2],
]


@pytest.mark.parametrize("rec", _EVENTS, ids=[str(i) for i in
                                               range(len(_EVENTS))])
def test_validate_event_agrees_with_jax(rec):
    def verdict(fn):
        try:
            fn(dict(rec) if isinstance(rec, dict) else rec)
            return "ok"
        except ValueError as e:
            return str(e)
    assert verdict(validate_event) == verdict(jmetrics.validate_event)


def test_files_off_logger_lines_and_events(tmp_path, monkeypatch):
    """``log_dir=None``: lines go to ``log``, events are validated and
    kept in memory, no file is written, and the methods that read the
    logger's clocks and config work as with files."""
    monkeypatch.chdir(tmp_path)
    lines = []
    cfg = ExperimentConfig(dataset=C.SYNTH_MNIST, users_count=4, epochs=2)
    logger = RunLogger(cfg, log_dir=None, log=lines.append)
    logger.print("hello")
    acc = logger.record_eval(epoch=3, test_loss=0.25, correct=7,
                             test_size=8)
    logger.record(kind="fault", round=3, quarantined=0)
    with pytest.raises(ValueError, match="missing required"):
        logger.record(kind="asr", round=3)
    beat = logger.heartbeat_fields()
    logger.dump_config()
    logger.finish()
    with pytest.raises(ValueError, match="after finish"):
        logger.record(kind="fault", round=4, quarantined=0)
    logger.close()
    assert lines[:2] == ["hello",
                         "Test set: [  3] Average loss: 0.2500, "
                         "Accuracy: 7/8 (87.50%)"]
    assert lines[2].startswith("{") and "'users_count': 4" in lines[2]
    assert lines[3:] == ["Max accuracy: 87.5"]
    assert acc == 87.5 and logger.accuracies_epochs == [3]
    assert beat["round"] == 3 and beat["last_event_age_s"] >= 0
    assert [e["kind"] for e in logger.events] == ["eval", "fault"]
    assert all(e["v"] == SCHEMA_VERSION for e in logger.events)
    assert logger.jsonl_path is None and list(tmp_path.iterdir()) == []


# ---------------------------------------------------------------------------
# the registry's writer side

def test_registry_entry_is_the_jax_registry_s(tmp_path):
    """A finished journaled port run: the port's index entry equals the
    JAX registry's entry for the same run dir, and the JAX registry
    resolves the stamped index line."""
    cfg = ExperimentConfig(dataset=C.SYNTH_MNIST, users_count=6,
                           mal_prop=0.2, batch_size=8, epochs=4, test_step=2,
                           synth_train=120, synth_test=30,
                           log_dir=str(tmp_path / "logs"),
                           run_dir=str(tmp_path / "runs"))
    ds = load_dataset(cfg.dataset, seed=0, synth_train=120, synth_test=30)
    exp = FederatedExperiment(cfg, DriftAttack(1.0), ds, device="cpu")
    with RunLogger(cfg, None, cfg.log_dir, jsonl_name="reg") as logger:
        exp.run(logger, journal=RunJournal(cfg.run_dir, "reg"))
    got = RunRegistry(cfg.run_dir)._entry_for_run("reg")
    want = JRegistry(cfg.run_dir)._entry_for_run("reg", migrate=False)
    assert got == want
    assert got["status"] == "done" and got["journal_high"] == 3
    assert got["event_kinds"]["eval"] == 3
    entry = JRegistry(cfg.run_dir).resolve("reg")
    assert entry["status"] == "done" and entry["defense"] == "NoDefense"
    with pytest.raises(ValueError, match="run_id"):
        RunRegistry(cfg.run_dir).stamp({"status": "done"})
