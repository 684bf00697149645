"""The port's measured walls (utils/walls.py, utils/profiling.py), trace
export (utils/trace_export.py) and the run loop's ``profile_every`` and
``timer=``, against the JAX package where it has a counterpart:

- ``book_events`` on constructed captures: on a CPU capture only the
  outermost ``cpu_op`` of each thread is booked (``aten::linear`` holds
  ``aten::addmm``: counted once), each to the innermost stage range open
  at its start; on the card each device event through its launch's
  correlation to the stage open around the launch, the projected
  ``gpu_user_annotation`` ranges where the launch is missing, else
  ``unattributed``; the partition exact;
- real CPU captures of port rounds (flat Krum, async Krum, hierarchical
  Krum/Krum): exact partitions, the outermost operations recounted,
  nothing filed under a kernel's entry point, since none ran; under a
  capture a kernel's launch, and only the launch, is a range named by its
  C entry point;
- ``measured_vs_modeled`` and ``events_to_trace`` equal to JAX's on the
  same input, JAX's ``validate_trace`` accepting the port's export, the
  'wall' and 'profile' events valid under both packages;
- ``profile_every`` and the timer on or off: weights byte-equal, the other
  events equal; nested captures; the CLI with all four flags on the CPU.
"""

import json
import math
import os
import types

import pytest
import torch

from attacking_federate_learning_tpu import cli as jax_cli
from attacking_federate_learning_tpu.utils import trace_export as JT
from attacking_federate_learning_tpu.utils import walls as JW
from attacking_federate_learning_tpu.utils.metrics import (
    validate_event as jax_validate_event
)
from attacking_federate_learning_tpu_torch import cli
from attacking_federate_learning_tpu_torch.attacks import DriftAttack
from attacking_federate_learning_tpu_torch.config import (
    ExperimentConfig, FaultConfig
)
from attacking_federate_learning_tpu_torch.core.engine import (
    FederatedExperiment
)
from attacking_federate_learning_tpu_torch.data.datasets import load_dataset
from attacking_federate_learning_tpu_torch.ops import _build
from attacking_federate_learning_tpu_torch.utils import costs as C
from attacking_federate_learning_tpu_torch.utils import trace_export as T
from attacking_federate_learning_tpu_torch.utils import walls as W
from attacking_federate_learning_tpu_torch.utils.metrics import (
    RunLogger, validate_event
)
from attacking_federate_learning_tpu_torch.utils.profiling import (
    PhaseTimer, device_trace
)

SMALL = dict(dataset="SYNTH_MNIST", users_count=12, mal_prop=0.25,
             batch_size=16, epochs=4, test_step=2, synth_train=400,
             synth_test=100)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ds():
    return load_dataset("SYNTH_MNIST", seed=0, synth_train=400,
                        synth_test=100)


def _x(cat, name, ts, dur, pid=1, tid=7, **args):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
          "pid": pid, "tid": tid}
    if args:
        ev["args"] = args
    return ev


# A CPU capture: the stages as user_annotation ranges, nested cpu_ops, a
# wrapper's range inside tier1_aggregate, an operation outside every
# stage, and a second thread with a stage of its own.
CPU_EVENTS = [
    _x("user_annotation", "deliver", 0.0, 100.0),
    _x("cpu_op", "aten::linear", 10.0, 40.0),
    _x("cpu_op", "aten::addmm", 15.0, 25.0),
    _x("cpu_op", "aten::mm", 20.0, 10.0),
    _x("cpu_op", "aten::mul", 60.0, 10.0),
    _x("user_annotation", "tier1_aggregate", 110.0, 90.0),
    _x("user_annotation", "fl_krum_scores", 120.0, 70.0),
    _x("cpu_op", "aten::topk", 130.0, 20.0),
    _x("cpu_op", "aten::sum", 195.0, 3.0),
    _x("cpu_op", "aten::add", 210.0, 10.0),
    _x("user_annotation", "apply", 0.0, 50.0, tid=8),
    _x("cpu_op", "aten::add_", 5.0, 7.0, tid=8),
    _x("python_function", "run_round", 0.0, 300.0),
]
CPU_WANT = ({"deliver": 50.0, "tier1_aggregate": 23.0, "apply": 7.0}, 10.0,
            {"fl_krum_scores": {"tier1_aggregate": [1, 20.0]},
             "aten::linear": {"deliver": [1, 40.0]},
             "aten::add": {"unattributed": [1, 10.0]}}, 0)
# A card capture: the host closes deliver (at 100) long before the kernel
# it launched runs (at 500); the launches carry the correlation ids.  The
# backward's kernel is launched by the autograd engine's device thread
# (tid 9, no range of its own) while the round's thread is in deliver.
# The wrapper's fill is launched in tier1_aggregate but outside the
# kernel's own range: it keeps its own name.
# Kernel 9's launch is not in the trace: the projected gpu range books
# it; kernel 10 has neither; the memcpy was launched outside the stages.
# The host's cpu_ops are not booked on a card capture.
CARD_EVENTS = [
    _x("user_annotation", "deliver", 0.0, 100.0),
    _x("cuda_runtime", "cudaLaunchKernel", 20.0, 5.0, correlation=5),
    _x("cuda_runtime", "cudaLaunchKernel", 60.0, 5.0, tid=9,
       correlation=11),
    _x("user_annotation", "tier1_aggregate", 110.0, 90.0),
    _x("cuda_runtime", "cudaLaunchKernel", 112.0, 3.0, correlation=12),
    _x("user_annotation", "fl_krum_scores", 120.0, 70.0),
    _x("cuda_driver", "cuLaunchKernel", 130.0, 4.0, correlation=6),
    _x("cuda_runtime", "cudaMemcpyAsync", 250.0, 6.0, correlation=7),
    _x("cpu_op", "aten::mm", 21.0, 3.0),
    _x("kernel", "gemm", 500.0, 30.0, pid=0, tid=3, correlation=5),
    _x("kernel", "sgemm_backward", 531.0, 6.0, pid=0, tid=3,
       correlation=11),
    _x("kernel", "krum_select", 540.0, 12.0, pid=0, tid=3, correlation=6),
    _x("kernel", "fill_zeros", 553.0, 3.0, pid=0, tid=3, correlation=12),
    _x("gpu_user_annotation", "apply", 600.0, 40.0, pid=0, tid=3),
    _x("kernel", "momentum", 610.0, 8.0, pid=0, tid=3, correlation=9),
    _x("kernel", "stray", 700.0, 2.0, pid=0, tid=3),
    _x("gpu_memcpy", "Memcpy HtoD", 560.0, 4.0, pid=0, tid=3,
       correlation=7),
]
CARD_WANT = ({"deliver": 36.0, "tier1_aggregate": 15.0, "apply": 8.0}, 6.0,
             {"gemm": {"deliver": [1, 30.0]},
              "sgemm_backward": {"deliver": [1, 6.0]},
              "fl_krum_scores": {"tier1_aggregate": [1, 12.0]},
              "fill_zeros": {"tier1_aggregate": [1, 3.0]},
              "momentum": {"apply": [1, 8.0]},
              "stray": {"unattributed": [1, 2.0]}}, 2)


@pytest.mark.parametrize("events,want", [(CPU_EVENTS, CPU_WANT),
                                         (CARD_EVENTS, CARD_WANT)],
                         ids=["cpu", "card"])
def test_book_events_on_constructed_captures(events, want):
    stages, unattributed, ops, unknown = want
    rec = W.book_events(events, name="fused_span", platform="cpu",
                        rounds=2)
    rec.check()
    assert rec.stages == stages
    assert rec.unattributed_us == unattributed
    assert rec.total_us == sum(stages.values()) + unattributed
    for label, cells in ops.items():
        assert rec.ops[label] == cells, label
    cov = rec.coverage
    assert cov["unknown_events"] == unknown
    assert cov["booked_us"] == rec.total_us
    assert cov["trace_events"] == len(events)
    if unknown:
        assert cov["runtime_us"] == 23.0
        assert cov["unknown_us"] == 10.0
        assert cov["op_time_fraction"] == round(
            (rec.total_us - 10.0) / rec.total_us, 4)
    ev = rec.wall_event()
    validate_event(ev)
    jax_validate_event(ev)
    # The payload is the JAX package's WallRecord's.
    jrec = JW.WallRecord(name=rec.name, platform=rec.platform,
                         rounds=rec.rounds, stages=rec.stages,
                         unattributed_us=rec.unattributed_us,
                         coverage=rec.coverage)
    assert ev == jrec.wall_event()


_MODELED = [
    ({"stages": {"deliver": 700.0, "tier1_aggregate": 250.0},
      "unattributed_us": 50.0},
     {"stages": {"deliver": {"flops": 6e9}, "tier1_aggregate":
                 {"flops": 1.6e9}, "apply": {"flops": 3e5}},
      "unattributed": {"flops": 2e7}}),
    ({"stages": {"protect": 10.0}}, {"stages": {}, "unattributed": {}}),
    ({"stages": {}, "unattributed_us": 0.0},
     {"stages": {"apply": {"flops": 1.0}}}),
]


@pytest.mark.parametrize("wall,cost", _MODELED)
def test_measured_vs_modeled_equals_jax(wall, cost):
    assert W.measured_vs_modeled(wall, cost) == JW.measured_vs_modeled(
        wall, cost)


def _outermost_total(path):
    """The CPU capture's outermost operations, found by containment."""
    evs = W.load_trace_events(path)
    ops = [e for e in evs if e.get("cat") == "cpu_op"]
    total = []
    for e in ops:
        s, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        inside = any(
            o is not e and o["tid"] == e["tid"] and o["pid"] == e["pid"]
            and float(o["ts"]) <= s
            and end <= float(o["ts"]) + float(o["dur"])
            and (float(o["ts"]), -float(o["dur"])) < (s, -float(e["dur"]))
            for o in ops)
        if not inside:
            total.append(float(e["dur"]))
    return len(total), math.fsum(total)


_CAPTURED = {  # name -> configuration
    "flat Krum": dict(defense="Krum"),
    "async Krum": dict(defense="Krum", aggregation="async", async_buffer=8,
                       staleness_weight="poly"),
    "hier Krum/Krum": dict(defense="Krum", aggregation="hierarchical",
                           megabatch=4, tier2_defense="Krum", mal_prop=0.1),
}


@pytest.mark.parametrize("name", sorted(_CAPTURED))
def test_real_cpu_captures_book_exactly(name, ds, tmp_path):
    kw = _CAPTURED[name]
    cfg = ExperimentConfig(**{**SMALL, **kw, "log_dir": str(tmp_path),
                              "profile_every": 1})
    exp = FederatedExperiment(cfg, DriftAttack(1.5), ds, device="cpu")
    logger = RunLogger(cfg, log_dir=None, log=lambda s: None)
    exp.run(logger)
    recs = exp.wall_records
    # Intervals [0], [1, 2], [3]: three captures, each booked.
    assert [r.rounds for r in recs] == [1, 2, 1]
    assert [os.path.basename(r.trace_dir) for r in recs] == [
        "r0", "r1", "r3"]
    for rec in recs:
        rec.check()
        count, total = _outermost_total(W.find_trace_file(rec.trace_dir))
        assert rec.coverage["op_events"] == count
        assert math.isclose(rec.total_us, total, rel_tol=1e-12)
        want = {"deliver", "tier1_aggregate", "apply"}
        if cfg.aggregation == "hierarchical":
            want.add("tier2_aggregate")
        if cfg.aggregation == "async":
            want.add("quarantine")
        assert want <= set(rec.stages)
        # No hand kernel ran: nothing is filed under a C entry point.
        assert not [k for k in rec.ops if k.startswith("fl_")], rec.ops
    walls = [e for e in logger.events if e["kind"] == "wall"]
    assert [e["source"] for e in walls] == [
        "host", "trace", "host"] * 2 + ["host", "trace", "host"]
    assert [e["name"] for e in walls if e["source"] == "host"] == [
        exp._span_entry_name(), "eval"] * 3
    for e in walls:
        validate_event(e)
        jax_validate_event(e)


def test_a_kernel_launch_is_labelled_only_under_a_capture(tmp_path,
                                                         monkeypatch):
    # A stand-in library: the C call runs one operation of its own.
    def fl_median(*args):
        torch.ones(5).mul_(2)
        return 0

    monkeypatch.setitem(_build._LOADED, "median",
                        types.SimpleNamespace(fl_median=fl_median))
    launch = _build.entry_point("median")
    assert launch(1, 2) == 0
    with device_trace(str(tmp_path), device="cpu"):
        with C.stage_scope("tier1_aggregate"):
            torch.zeros(4).add_(1)          # the wrapper's own fill
            assert launch(3, 4) == 0
    rec = W.book_trace(str(tmp_path))
    labels = {k: set(v) for k, v in rec.ops.items()}
    # Only the C call is filed under its entry point; the fill beside it
    # keeps its own name, in the same stage.
    assert labels.pop("fl_median") == {"tier1_aggregate"}
    assert labels and all(v == {"tier1_aggregate"} for v in labels.values())
    assert rec.ops["fl_median"]["tier1_aggregate"][0] == 2   # ones, mul_
    assert not [k for k in labels if k.startswith("fl_")]


def _run(cfg, ds, **kw):
    exp = FederatedExperiment(cfg, DriftAttack(1.5), ds, device="cpu")
    logger = RunLogger(cfg, log_dir=None, log=lambda s: None)
    exp.run(logger, **kw)
    return exp, logger.events


def _same_state(a, b):
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in ((a.state.weights, b.state.weights),
                            (a.state.velocity, b.state.velocity)))


def _strip(events, drop=("wall", "profile")):
    """The events but the walls' and the profile, as JSON (NaN equal to
    NaN), without their timestamps."""
    return json.dumps([{k: v for k, v in e.items() if k != "t"}
                       for e in events if e["kind"] not in drop],
                      sort_keys=True)


_OBSERVED = {
    "flat TrimmedMean faulted": dict(
        defense="TrimmedMean", faults=FaultConfig(dropout=0.1,
                                                   straggler=0.1,
                                                   corrupt=0.05),
        telemetry=True, margins=True),
    "async Median": dict(defense="Median", aggregation="async",
                         async_buffer=8, staleness_weight="const"),
    "hier Median/Krum": dict(defense="Median", aggregation="hierarchical",
                             megabatch=4, tier2_defense="Krum",
                             mal_prop=0.1, numerics=True),
}


@pytest.mark.parametrize("name", sorted(_OBSERVED))
def test_walls_and_timer_leave_the_run_as_it_was(name, ds, tmp_path):
    cfg = ExperimentConfig(**{**SMALL, **_OBSERVED[name],
                              "log_dir": str(tmp_path)})
    off, off_ev = _run(cfg, ds)
    on_cfg = ExperimentConfig(**{**SMALL, **_OBSERVED[name],
                                 "log_dir": str(tmp_path),
                                 "profile_every": 2})
    timer = PhaseTimer()
    on, on_ev = _run(on_cfg, ds, timer=timer)
    assert _same_state(on, off)
    assert _strip(on_ev) == _strip(off_ev)
    kinds = [e["kind"] for e in on_ev]
    # Intervals [0], [1, 2], [3]: the first and third captured.
    assert kinds.count("wall") == 3 + 3 + 2
    assert [r.trace_dir for r in on.wall_records] == [
        os.path.join(str(tmp_path), "walltrace", f"r{t}") for t in (0, 3)]
    profile, = [e for e in on_ev if e["kind"] == "profile"]
    assert profile["phases"]["round"]["count"] == 4
    assert profile["phases"]["eval"]["count"] == 3
    validate_event(profile)
    jax_validate_event(profile)
    assert not off.wall_records


def test_a_failed_booking_is_printed_and_the_run_goes_on(ds, tmp_path,
                                                          monkeypatch):
    def broken(*a, **k):
        raise ValueError("no trace")

    monkeypatch.setattr(W, "book_trace", broken)
    cfg = ExperimentConfig(**{**SMALL, "defense": "Krum", "epochs": 2,
                              "log_dir": str(tmp_path), "profile_every": 1})
    lines = []
    exp = FederatedExperiment(cfg, DriftAttack(1.5), ds, device="cpu")
    out = exp.run(log=lines.append)
    assert len(out["accuracies"]) == 2
    assert lines.count("[walls] booking failed: ValueError: no trace") == 2
    assert not exp.wall_records


def test_nested_captures_pause_the_outer_one(tmp_path):
    outer, inner = tmp_path / "outer", tmp_path / "inner"
    with device_trace(str(outer), "cpu"):
        x = torch.ones(4) * 2
        with device_trace(str(inner), "cpu"):
            with C.stage_scope("apply"):
                x = x + 1
        x = x - 1
    assert sorted(p.name.split(".", 1)[1] for p in outer.iterdir()) == [
        "1.trace.json", "trace.json"]
    rec = W.book_trace(str(inner), name="inner")
    assert set(rec.stages) == {"apply"}
    assert C._ARMED == C._CAPTURES == 0


def test_events_to_trace_equals_jax_and_jax_validates_the_export(
        ds, tmp_path):
    cfg = ExperimentConfig(**{**SMALL, "defense": "Krum",
                              "aggregation": "hierarchical",
                              "megabatch": 4, "tier2_defense": "Krum",
                              "mal_prop": 0.1, "telemetry": True,
                              "margins": True, "numerics": True,
                              "profile_every": 1,
                              "log_dir": str(tmp_path / "logs")})
    exp = FederatedExperiment(cfg, DriftAttack(1.5), ds, device="cpu")
    with RunLogger(cfg, log_dir=str(tmp_path / "logs"),
                   jsonl_name="run") as logger:
        exp.cost_report(logger)
        exp.run(logger, timer=PhaseTimer())
    path = str(tmp_path / "logs" / "run.jsonl")
    with open(path) as fh:
        events = [json.loads(line) for line in fh]
    kinds = {e["kind"] for e in events}
    assert {"wall", "profile", "cost", "stage_cost", "wire_bytes",
            "shard_selection", "margin", "numerics"} <= kinds
    assert T.events_to_trace(events, "run") == JT.events_to_trace(
        events, "run")
    out = T.export_trace(path, validate=True)
    with open(out) as fh:
        trace = json.load(fh)
    assert JT.validate_trace(trace) == [] == T.validate_trace(trace)
    assert any(e.get("name", "").startswith("hier_tele_span:")
               for e in trace["traceEvents"])


def test_cli_flags_are_jax_s():
    def actions(parser):
        return {a.dest: (a.option_strings, a.default, a.type, a.metavar,
                         a.nargs) for a in parser._actions
                if a.dest in ("profile", "trace_dir", "profile_every",
                              "cost_report")}

    assert actions(cli.build_parser()) == actions(jax_cli.build_parser())
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        ["--profile-every", "3"]))
    assert cfg.profile_every == 3


def test_cli_with_the_four_flags_on_the_cpu(tmp_path, capsys):
    logs, trace = tmp_path / "l", tmp_path / "t"
    out = cli.main(["-s", "SYNTH_MNIST", "-d", "Krum", "-n", "8", "-m",
                    "0.25", "-e", "3", "-c", "16", "--test-step", "2",
                    "--synth-train", "200", "--synth-test", "40",
                    "--profile", "--trace-dir", str(trace),
                    "--profile-every", "1", "--cost-report",
                    "--log-dir", str(logs), "--run-dir", str(tmp_path / "r"),
                    "--device", "cpu"])
    assert all(math.isfinite(a) for a in out["accuracies"])
    text = capsys.readouterr().out
    assert "[cost] fused_round" in text and "phase_timing" in text
    # The captures beside the counted stage shares (measured_vs_modeled).
    walls = [ln.split() for ln in text.splitlines()
             if ln.startswith("[walls] fused_span ")]
    assert {"deliver", "tier1_aggregate", "apply"} <= {w[2] for w in walls}
    assert all(w[-1].startswith("ratio=") for w in walls)
    jsonl, = [p for p in logs.iterdir() if p.suffix == ".jsonl"]
    with open(jsonl) as fh:
        kinds = [json.loads(line)["kind"] for line in fh]
    assert kinds.count("cost") == kinds.count("stage_cost") == 5
    assert kinds.count("wire_bytes") == kinds.count("profile") == 1
    # Intervals [0] and [1, 2]: a host wall, a booked capture and an eval
    # wall each.
    assert kinds.count("wall") == 2 * 3
    # The whole run's capture, paused around each interval's.
    assert len([p for p in trace.iterdir()
                if p.name.endswith(".trace.json")]) == 3
    assert sorted(p.name for p in (logs / "walltrace").iterdir()) == [
        "r0", "r1"]


def test_cli_trace_exports_the_event_log(tmp_path, capsys):
    logs = tmp_path / "l"
    cli.main(["-s", "SYNTH_MNIST", "-d", "Median", "-n", "8", "-m", "0.25",
              "-e", "2", "-c", "16", "--test-step", "1", "--synth-train",
              "200", "--synth-test", "40", "--profile-every", "1",
              "--log-dir", str(logs), "--run-dir", str(tmp_path / "r"),
              "--device", "cpu"])
    jsonl, = [p for p in logs.iterdir() if p.suffix == ".jsonl"]
    out = tmp_path / "run.trace.json"
    with pytest.raises(SystemExit) as done:
        cli.main(["trace", str(jsonl), "-o", str(out)])
    assert done.value.code == 0
    assert f"wrote {out}" in capsys.readouterr().out
    with open(out) as fh:
        trace = json.load(fh)
    assert JT.validate_trace(trace) == []
    assert any(e.get("name", "").startswith("fused_span:")
               for e in trace["traceEvents"])
    with pytest.raises(SystemExit) as done:
        cli.main(["trace", str(tmp_path / "missing.jsonl")])
    assert done.value.code == 1
