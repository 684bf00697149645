"""The port's supervisor (supervisor.py), the JAX package's
tools/supervisor.py on the port's CLI.

- The degradation ladder keeps the card: 'oom' halves the batch (no mesh
  step), 'backend' is a plain retry and never a move to the CPU, and a
  'backend' failure ends supervision with exit 1 after the retries.
- The stall steps append only flags the port's config accepts for the
  run (``--backdoor-staged`` is refused with a backdoor).
- The child is ``python -m attacking_federate_learning_tpu_torch.cli``,
  journaled under the pinned run id, on the card unless its own flags say
  ``--device cpu``; resume only on the run's own progress.
- A supervised CPU run with ``--inject-preempt-round`` exits 75 once,
  resumes, and ends bit for bit where the same run uninterrupted ends,
  though another run saved a later best checkpoint in the shared
  dataset dir between its attempts.
- Backoff, failure classes and build_opts are the JAX supervisor's.
"""

import importlib.util
import json
import os
import random
import sys

import numpy as np
import pytest

from attacking_federate_learning_tpu_torch import cli
from attacking_federate_learning_tpu_torch import supervisor as S
from attacking_federate_learning_tpu_torch.utils.lifecycle import RunJournal
from attacking_federate_learning_tpu_torch.utils.metrics import iter_events

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_supervisor():
    spec = importlib.util.spec_from_file_location(
        "jax_supervisor", os.path.join(ROOT, "tools", "supervisor.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _child(tmp_path, *extra):
    return ["-s", "SYNTH_MNIST", "-n", "6", "-m", "0.2", "-e", "6", "-c",
            "8", "--synth-train", "120", "--synth-test", "30",
            "--log-dir", str(tmp_path / "logs"),
            "--run-dir", str(tmp_path / "runs"), *extra]


def _sup(tmp_path, *extra, **opts):
    opts.setdefault("events", str(tmp_path / "sup.jsonl"))
    return S.Supervisor(S.build_opts(**opts), _child(tmp_path, *extra))


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_options_and_backoff_are_jax_s():
    J = _jax_supervisor()
    assert S.OPTION_DEFAULTS == J.OPTION_DEFAULTS
    with pytest.raises(ValueError, match="unknown supervisor options"):
        S.build_opts(mesh=1)
    for failures in range(6):
        a = S.Supervisor(S.build_opts(raw=True, run_id="r"), ["true"])
        b = J.Supervisor(J.build_opts(raw=True, run_id="r"), ["true"])
        a.rng, b.rng = random.Random(7), random.Random(7)
        a.failures = b.failures = failures
        assert a.backoff("crash") == b.backoff("crash")
        assert a.backoff("preempted") == 0.0


def test_child_is_the_port_cli_on_the_card(tmp_path):
    sup = _sup(tmp_path, run_id="c1")
    cmd = sup.build_cmd(1)
    assert cmd[:3] == [sys.executable, "-m",
                       "attacking_federate_learning_tpu_torch.cli"]
    assert cmd[3 + len(sup.child_args):] == [
        "--journal", "--run-id", "c1", "--checkpoint-every", "5"]
    ns = cli.build_parser().parse_args(cmd[3:])
    assert ns.device == "cuda" and ns.journal and ns.run_id == "c1"
    assert "--resume" not in cmd        # no progress of its own yet
    # The best save in the shared dataset dir is never a resume target,
    # not even once this run has a manifest; its own newest auto is.
    shared = tmp_path / "runs" / "SYNTH_MNIST"
    os.makedirs(shared)
    (shared / "checkpoint.npz").write_bytes(b"x")
    assert "--resume" not in sup.build_cmd(1)
    own = tmp_path / "runs" / "c1"
    os.makedirs(own)
    (own / "manifest.json").write_text("{}")
    assert "--resume" not in sup.build_cmd(2)
    for r in (5, 10):
        (own / f"checkpoint-auto-{r:08d}.npz").write_bytes(b"x")
    cmd = sup.build_cmd(2)
    assert cmd[cmd.index("--resume") + 1] == str(
        own / "checkpoint-auto-00000010.npz")
    assert sup._jsonl_path() == str(tmp_path / "logs" / "c1.jsonl")


def test_the_ladder_keeps_the_card(tmp_path):
    sup = _sup(tmp_path, run_id="l1")
    assert sup.degrade_for("oom") == "batch_halved_to_4"
    assert sup.degrade_for("oom") == "batch_halved_to_2"
    assert sup.degrade_for("oom") == "batch_halved_to_1"
    assert sup.degrade_for("oom") is None          # the floor
    for _ in range(3):
        assert sup.degrade_for("backend") is None
    assert sup.degrade_flags == ["-c", "4", "-c", "2", "-c", "1"]
    flat = " ".join(sup.degrade_flags + sup.build_cmd(2))
    for word in ("--backend", "--mesh-shape", "cpu"):
        assert word not in flat.replace(str(tmp_path), "")


def test_stall_steps_only_what_the_config_accepts(tmp_path):
    sup = _sup(tmp_path, "-d", "TrimmedMean", "--aggregation", "async",
               "--async-buffer", "4", run_id="s1")
    sup.class_counts["stall"] = 1
    assert sup.degrade_for("stall") is None        # the first stall
    sup.class_counts["stall"] = 2
    assert sup.degrade_for("stall") == "async_sync_fallback"
    assert sup.degrade_flags == ["--aggregation", "flat"]
    # The staged path: the port's CLI has no --backdoor-staged (its
    # config refuses backdoor_fused=False with a backdoor), so the step
    # is never taken.
    assert sup.degrade_for("stall") is None
    assert "--backdoor-staged" not in sup.parser._option_string_actions
    sup = _sup(tmp_path, "-b", "pattern", run_id="s2")
    sup.class_counts["stall"] = 2
    assert sup.degrade_for("stall") is None
    assert sup.degrade_flags == []


def test_a_backend_failure_fails_after_the_retries(tmp_path, monkeypatch):
    sup = _sup(tmp_path, run_id="b1", max_retries=2, backoff_base=0.0,
               poll_interval=0.01)
    fail = [sys.executable, "-c",
            "import sys; sys.stderr.write('Unable to initialize backend "
            "cuda'); sys.exit(1)"]
    monkeypatch.setattr(sup, "build_cmd", lambda attempt: list(fail))
    assert sup.supervise() == 1
    evs = _events(tmp_path / "sup.jsonl")
    phases = [e["phase"] for e in evs]
    assert phases.count("attempt") == 3
    assert [e["failure"] for e in evs if e["phase"] == "retry"] == [
        "backend", "backend"]
    assert phases[-1] == "exhausted" and "degrade" not in phases
    assert sup.degrade_flags == []


def _newest_auto(run_dir):
    autos = sorted(n for n in os.listdir(run_dir)
                   if n.startswith("checkpoint-auto-") and n.endswith(".npz"))
    with np.load(os.path.join(run_dir, autos[-1])) as z:
        return autos[-1], {k: z[k] for k in z.files}


def _plant_foreign_best(run_dir, run_id):
    """Another run over the dataset saving its best meanwhile: a best
    checkpoint in the shared runs/<dataset>/ at a later round than this
    run's newest auto, with other weights."""
    newest = sorted((run_dir / run_id).glob("checkpoint-auto-*.npz"))[-1]
    with np.load(newest) as z:
        arrays = dict(z)
    arrays["weights"] = arrays["weights"] + 1.0
    arrays["round"] = np.int32(int(arrays["round"]) + 2)
    arrays["accuracy"] = np.float32(100.0)
    np.savez(run_dir / "SYNTH_MNIST" / "checkpoint.npz", **arrays)


def test_injected_preempt_resumes_bit_for_bit(tmp_path):
    flags = ["--checkpoint-every", "2", "--device", "cpu"]
    sup = S.Supervisor(S.build_opts(run_id="pre", verify_journal=True,
                                    inject_preempt_round=2,
                                    poll_interval=0.05, backoff_base=0.0,
                                    events=str(tmp_path / "sup.jsonl")),
                       _child(tmp_path / "a", *flags))
    build = sup.build_cmd

    def build_after_a_foreign_save(attempt):
        if attempt == 2:
            _plant_foreign_best(tmp_path / "a" / "runs", "pre")
        return build(attempt)

    sup.build_cmd = build_after_a_foreign_save
    env_before = dict(os.environ)
    assert sup.supervise() == 0
    assert dict(os.environ) == env_before
    phases = [(e["phase"], e.get("failure"))
              for e in _events(tmp_path / "sup.jsonl")]
    assert ("retry", "preempted") in phases
    assert [p for p, _ in phases].count("attempt") == 2
    # The same run, uninterrupted, in the process.
    cli.main(_child(tmp_path / "b", *flags, "--run-id", "pre"))
    name_a, a = _newest_auto(tmp_path / "a" / "runs" / "pre")
    name_b, b = _newest_auto(tmp_path / "b" / "runs" / "pre")
    assert name_a == name_b
    for key in ("weights", "velocity"):
        assert np.array_equal(a[key], b[key]), key

    def evals(root):
        return [{k: v for k, v in e.items() if k != "t"}
                for e in iter_events(root / "logs" / "pre.jsonl")
                if e["kind"] == "eval"]

    assert evals(tmp_path / "a") == evals(tmp_path / "b")
    journal = RunJournal(str(tmp_path / "a" / "runs"), "pre")
    assert journal.verify(epochs=6, test_step=5) == []
    assert journal.read_manifest()["status"] == "done"


def test_main_supervises_a_raw_command(tmp_path):
    events = tmp_path / "raw.jsonl"
    rc = S.main(["--raw", "--events", str(events), "--", sys.executable,
                 "-c", "print('hi')"])
    assert rc == 0
    assert [e["phase"] for e in _events(events)] == [
        "supervise_start", "attempt", "supervise_done"]
    with pytest.raises(SystemExit):
        S.main(["--raw"])
