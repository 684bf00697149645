"""Run supervisor: bounded retry + backoff + degradation around a run.

The port's copy of the JAX package's ``tools/supervisor.py``, a module
of the package:

    python -m attacking_federate_learning_tpu_torch.supervisor [options] \
        -- -d Krum -s SYNTH_MNIST -e 30
    python -m attacking_federate_learning_tpu_torch.supervisor --raw \
        [options] -- python some_step.py

It wraps a port CLI run (``python -m attacking_federate_learning_tpu_torch
.cli``, on the card unless the child's flags say ``--device cpu``) or an
arbitrary command (``--raw``) with the run lifecycle
(utils/lifecycle.py): failures are classified, retried with exponential
backoff, resumed from the newest checkpoint and, where the failure class
calls for it, the run is degraded rather than merely retried.  Every
step of the ladder keeps the run on the card and on its kernels.

Failure taxonomy (utils/lifecycle.py:classify_failure):

- ``preempted`` (exit 75): the child checkpointed on SIGTERM/SIGINT;
  resume at once, no backoff, no retry-budget charge.
- ``divergence`` (exit 76 / divergence markers): deterministic; retrying
  the identical config reproduces it, so supervision stops FATALLY.
- ``oom``: halve the client batch (``-c``), floor 1; a loud 'degrade'
  lifecycle event.  There is no mesh to relax.
- ``backend``: a plain retry within ``--max-retries``, then a loud
  failure.  There is no fallback to the CPU: it would carry the run on
  without the card.
- ``stall``: no event progress for ``--stall-timeout`` seconds (read
  from the child's event JSONL: the last heartbeat's last-event age, or
  the file mtime); the supervisor SIGTERMs (the child checkpoints at the
  next boundary), and escalates to SIGKILL after ``--stall-grace``.  A
  second stall degrades: an async run falls back to synchronous rounds
  (``--aggregation flat``), then to ``--backdoor-staged``; each step is
  taken only where the port's config accepts the run with it.
- ``crash``: anything else; plain retry with backoff.

Exactly-once accounting: the child always runs with ``--journal`` and a
supervisor-pinned ``--run-id`` (so degraded restarts share one journal);
``--verify-journal`` audits the journal after completion and fails
supervision on any double- or never-counted round or eval.  A run
resumes only on its own progress: the newest auto-checkpoint in its
runs/<run_id>/, named on the child's ``--resume``.

Exit status: the child's final exit code (0 on success), 1 when the
retry budget is exhausted or the journal audit fails.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

from attacking_federate_learning_tpu_torch.utils.lifecycle import (
    EXIT_PREEMPTED, RunJournal, classify_failure, run_id_for
)
from attacking_federate_learning_tpu_torch.utils.metrics import (
    SCHEMA_VERSION, validate_event
)

# The child of a non-raw supervision.
CHILD_MODULE = "attacking_federate_learning_tpu_torch.cli"

STDERR_TAIL_BYTES = 8192
MAX_PREEMPT_RESUMES = 100   # safety backstop, not a budget: preempts are
#                             externally caused and individually cheap

# Defaults for every supervisor option (the argparse surface below and
# build_opts share these, so programmatic callers can't drift).
OPTION_DEFAULTS = dict(raw=False, max_retries=3, backoff_base=2.0,
                       backoff_max=60.0, checkpoint_every=5,
                       stall_timeout=0.0, stall_grace=30.0,
                       poll_interval=1.0, run_id=None, events=None,
                       verify_journal=False, inject_preempt_round=None,
                       child_env=None)


def build_opts(**overrides):
    """Options namespace for programmatic supervision (the campaign
    scheduler drives Supervisor objects directly; campaigns/
    scheduler.py).  ``child_env`` is a dict of environment overrides
    merged into every child attempt: the campaign pins its kernel-library
    build directory there."""
    unknown = set(overrides) - set(OPTION_DEFAULTS)
    if unknown:
        raise ValueError(f"unknown supervisor options {sorted(unknown)}")
    return argparse.Namespace(**{**OPTION_DEFAULTS, **overrides})


class Supervisor:
    def __init__(self, opts, child_args):
        self.opts = opts
        self.raw = opts.raw
        self.child_args = list(child_args)
        # Backoff jitter stream: seeded per PROCESS (pid + clock), so k
        # children supervising identical configs draw different sleeps
        # (see backoff()); tests inject a seeded Random here.
        import random
        self.rng = random.Random((os.getpid() << 20)
                                 ^ time.time_ns())
        self.failures = 0          # counted against --max-retries
        self.preempts = 0
        self.class_counts = {}
        self.degrade_flags = []
        self._events_fh = None
        if self.raw:
            self.run_id = opts.run_id or f"raw_{int(time.time())}"
            self.cfg = None
            self.events_path = opts.events or os.path.join(
                "logs", f"supervisor_{self.run_id}.jsonl")
        else:
            # Parse the child's flag surface once: run/log dirs, the
            # journal identity and the event-stream path all derive
            # from it (cli.build_parser is argparse only).
            from attacking_federate_learning_tpu_torch.cli import (
                build_parser, config_from_args
            )
            self.parser = build_parser()
            self.config_from_args = config_from_args
            ns = self.parser.parse_args(self.child_args)
            self.cfg = config_from_args(ns)
            self.run_id = opts.run_id or ns.run_id or run_id_for(self.cfg)
            self.events_path = opts.events or os.path.join(
                self.cfg.log_dir, f"supervisor_{self.run_id}.jsonl")

    # --- supervisor's own lifecycle event stream -----------------------
    def emit(self, phase, **fields):
        rec = {"kind": "lifecycle", "phase": phase, "v": SCHEMA_VERSION,
               "t": round(time.time(), 3), "run_id": self.run_id,
               **fields}
        validate_event(rec)
        if self._events_fh is None:
            os.makedirs(os.path.dirname(self.events_path) or ".",
                        exist_ok=True)
            self._events_fh = open(self.events_path, "a")
        self._events_fh.write(json.dumps(rec) + "\n")
        self._events_fh.flush()
        line = "  ".join(f"{k}={v}" for k, v in fields.items())
        # stderr, deliberately: a wrapped step's stdout may be a data
        # artifact (bench.py's JSON) that supervisor chatter must not
        # corrupt.
        print(f"[supervisor] {phase}  {line}", file=sys.stderr,
              flush=True)

    # --- child command construction ------------------------------------
    def _effective_ns(self):
        return self.parser.parse_args(self.child_args + self.degrade_flags)

    def _own_checkpoint(self):
        """The newest auto-checkpoint in this run's own runs/<run_id>/, or
        None.  The best-accuracy save in the shared runs/<dataset>/ is
        never a resume target here: runs over one dataset that run at
        once overwrite it, so it may be another run's."""
        autos = sorted(glob.glob(os.path.join(
            self.cfg.run_dir, self.run_id, "checkpoint-auto-*.npz")))
        return autos[-1] if autos else None

    def build_cmd(self, attempt):
        if self.raw:
            return list(self.child_args)
        cmd = [sys.executable, "-m", CHILD_MODULE]
        cmd += self.child_args
        cmd += ["--journal", "--run-id", self.run_id]
        if "--checkpoint-every" not in self.child_args:
            cmd += ["--checkpoint-every", str(self.opts.checkpoint_every)]
        cmd += self.degrade_flags
        # Resume only on THIS run-id's own progress: its newest
        # auto-checkpoint, named, so cli.py's --resume 'auto' never lets
        # the shared best save compete.
        own = self._own_checkpoint()
        if own is not None:
            cmd += ["--resume", own]
        return cmd

    # --- degradation ladder --------------------------------------------
    def _accepts(self, flags) -> bool:
        """True when the port's CLI has ``flags`` and the run with them
        appended passes its config and the engine's pure composition
        checks (campaigns/spec.py validate_composition)."""
        from attacking_federate_learning_tpu_torch.campaigns.spec import (
            validate_composition
        )

        known = self.parser._option_string_actions
        if any(f.startswith("-") and f not in known for f in flags):
            return False
        try:
            validate_composition(self.config_from_args(
                self.parser.parse_args(
                    self.child_args + self.degrade_flags + list(flags))))
        except (ValueError, TypeError, SystemExit):
            return False
        return True

    def degrade_for(self, cls):
        """Append degradation flags for one failure class; returns a
        description of the step taken (None = no degradation, plain
        retry).  Flags are APPENDED so argparse last-wins overrides the
        original value — the original command stays legible in ps.
        Every step keeps the run on the card: a 'backend' failure is a
        plain retry (the budget then fails it loudly), never a move to
        the CPU."""
        if self.raw:
            return None
        if cls == "oom":
            ns = self._effective_ns()
            new_bs = max(1, ns.batch_size // 2)
            if new_bs == ns.batch_size:
                return None          # floor reached; plain retry
            self.degrade_flags += ["-c", str(new_bs)]
            return f"batch_halved_to_{new_bs}"
        if cls == "stall" and self.class_counts.get("stall", 0) >= 2:
            ns = self._effective_ns()
            if (ns.aggregation == "async"
                    and "--aggregation" not in self.degrade_flags
                    and self._accepts(["--aggregation", "flat"])):
                # An async-mode stall falls back to synchronous rounds
                # first (argparse last-wins); the staged path below
                # stays the last resort.
                self.degrade_flags += ["--aggregation", "flat"]
                return "async_sync_fallback"
            if ("--backdoor-staged" not in self.degrade_flags
                    and self._accepts(["--backdoor-staged"])):
                self.degrade_flags += ["--backdoor-staged"]
                return "staged_fallback"
        return None

    # --- stall detection ------------------------------------------------
    def _jsonl_path(self):
        """The child's event log: a journaled run's is named by its run
        id (cli.py), and the child always runs journaled."""
        if self.raw or self.cfg is None:
            return None
        return os.path.join(self.cfg.log_dir, self.run_id + ".jsonl")

    def _event_age(self, path, started_at):
        """Seconds since the child last made observable progress: the
        last heartbeat's REAL-event age when one is present (heartbeats
        keep the file mtime fresh precisely while stalled — mtime alone
        would mask the stall), else the file mtime, else child start."""
        try:
            with open(path, "rb") as f:
                tail = f.read()[-4096:].decode(errors="replace")
            lines = [ln for ln in tail.splitlines() if ln.strip()]
            for ln in reversed(lines):
                try:
                    rec = json.loads(ln)
                except json.JSONDecodeError:
                    continue
                if rec.get("kind") == "heartbeat":
                    return float(rec.get("last_event_age_s", 0.0))
                break                    # newest line is a real event
            return time.time() - os.path.getmtime(path)
        except OSError:
            return time.time() - started_at

    # --- one attempt -----------------------------------------------------
    def run_attempt(self, attempt):
        cmd = self.build_cmd(attempt)
        self.emit("attempt", attempt=attempt,
                  cmd=" ".join(cmd), degraded=" ".join(self.degrade_flags))
        stderr_f = tempfile.NamedTemporaryFile(
            prefix="supervisor_stderr_", suffix=".log", delete=False)
        started = time.time()
        env = dict(os.environ)
        env.update(getattr(self.opts, "child_env", None) or {})
        if self.opts.inject_preempt_round is not None:
            env["FL_PREEMPT_AT_ROUND"] = str(self.opts.inject_preempt_round)
        proc = subprocess.Popen(cmd, stderr=stderr_f, env=env)
        stalled = False
        jsonl = self._jsonl_path()
        while proc.poll() is None:
            time.sleep(self.opts.poll_interval)
            if not self.opts.stall_timeout:
                continue
            age = self._event_age(jsonl, started) if jsonl else (
                time.time() - started)
            if age > self.opts.stall_timeout:
                stalled = True
                self.emit("stall_kill", attempt=attempt,
                          event_age_s=round(age, 1))
                proc.send_signal(signal.SIGTERM)   # graceful first: the
                try:                               # child checkpoints at
                    proc.wait(self.opts.stall_grace)  # the next boundary
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
                break
        rc = proc.wait()
        stderr_f.close()
        with open(stderr_f.name, "rb") as f:
            f.seek(max(0, os.path.getsize(stderr_f.name)
                       - STDERR_TAIL_BYTES))
            tail = f.read().decode(errors="replace")
        os.unlink(stderr_f.name)
        return rc, tail, stalled

    # --- main loop --------------------------------------------------------
    def backoff(self, cls):
        """Bounded exponential backoff with decorrelation jitter.

        k identical campaign children that crash on the same cause
        (a lost device, a full disk) all compute the same exponential
        envelope — without jitter they wake in lockstep and re-collide
        every cycle.  The sleep is drawn uniformly from the upper half
        of the envelope, ``[env/2, env]`` with
        ``env = min(backoff_max, backoff_base * 2**(failures-1))``:
        still exponentially growing and still capped, but any two
        children decorrelate by up to half a cycle.  The draw comes
        from ``self.rng`` — a PROCESS-seeded stream (never the
        experiment seed: children sharing a config must not share
        sleeps), injectable for tests."""
        if cls == "preempted":
            return 0.0
        n = max(0, self.failures - 1)
        env = min(self.opts.backoff_max,
                  self.opts.backoff_base * (2 ** n))
        return env / 2.0 + self.rng.random() * (env / 2.0)

    def verify_journal(self):
        if self.raw or not self.opts.verify_journal:
            return []
        journal = RunJournal(self.cfg.run_dir, self.run_id)
        ns = self._effective_ns()
        return journal.verify(epochs=ns.epochs,
                              test_step=self.cfg.test_step)

    def supervise(self) -> int:
        attempt = 0
        self.emit("supervise_start", raw=int(self.raw),
                  max_retries=self.opts.max_retries)
        while True:
            attempt += 1
            rc, tail, stalled = self.run_attempt(attempt)
            cls = classify_failure(rc, tail, stalled)
            self.class_counts[cls] = self.class_counts.get(cls, 0) + 1
            if cls == "done":
                problems = self.verify_journal()
                if problems:
                    self.emit("fatal", attempt=attempt,
                              failure="journal_audit",
                              problems="; ".join(problems))
                    return 1
                self.emit("supervise_done", attempts=attempt,
                          failures=self.failures, preempts=self.preempts)
                return 0
            if cls == "divergence":
                self.emit("fatal", attempt=attempt, failure=cls,
                          returncode=rc)
                print(tail[-2000:], file=sys.stderr)
                return rc if rc else 1
            if cls == "preempted":
                self.preempts += 1
                if self.preempts > MAX_PREEMPT_RESUMES:
                    self.emit("exhausted", attempt=attempt,
                              failure="preempt_loop")
                    return 1
                self.emit("retry", attempt=attempt, failure=cls,
                          returncode=EXIT_PREEMPTED, backoff_s=0)
                continue
            # Retryable failure: charge the budget, maybe degrade.
            self.failures += 1
            if self.failures > self.opts.max_retries:
                self.emit("exhausted", attempt=attempt, failure=cls,
                          failures=self.failures)
                print(tail[-2000:], file=sys.stderr)
                return 1
            step = self.degrade_for(cls)
            if step:
                self.emit("degrade", attempt=attempt, failure=cls,
                          step=step, flags=" ".join(self.degrade_flags))
            wait = self.backoff(cls)
            self.emit("retry", attempt=attempt, failure=cls,
                      returncode=rc, backoff_s=round(wait, 2))
            if wait:
                time.sleep(wait)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="attacking_federate_learning_tpu_torch.supervisor",
        description="Supervise a port run: bounded retry + backoff, "
                    "failure classification, degradation ladder, "
                    "checkpoint resume, exactly-once journal audit.  "
                    "Child args follow '--' (the port CLI's flags by "
                    "default, a full command with --raw).")
    p.add_argument("--raw", action="store_true",
                   help="treat child args as a complete command instead "
                        "of cli.py flags (retry/backoff only: no resume "
                        "flags, no journal, no degradation)")
    p.add_argument("--max-retries", default=3, type=int,
                   help="retryable-failure budget (preempt resumes are "
                        "not charged)")
    p.add_argument("--backoff-base", default=2.0, type=float)
    p.add_argument("--backoff-max", default=60.0, type=float)
    p.add_argument("--checkpoint-every", default=5, type=int,
                   help="auto-checkpoint cadence forced onto the child "
                        "when it doesn't set one (resume granularity)")
    p.add_argument("--stall-timeout", default=0.0, type=float,
                   metavar="SECS",
                   help="kill + retry when the child makes no event "
                        "progress for SECS (heartbeat-aware); 0 = off")
    p.add_argument("--stall-grace", default=30.0, type=float,
                   help="seconds between the graceful SIGTERM and the "
                        "SIGKILL escalation on a stalled child")
    p.add_argument("--poll-interval", default=1.0, type=float)
    p.add_argument("--run-id", default=None,
                   help="journal identity (default: derived from the "
                        "child config; pinned across degraded restarts)")
    p.add_argument("--events", default=None, metavar="JSONL",
                   help="supervisor lifecycle-event stream (default "
                        "<log_dir>/supervisor_<run_id>.jsonl)")
    p.add_argument("--verify-journal", action="store_true",
                   help="after completion, audit the journal for "
                        "exactly-once round/eval coverage; violations "
                        "fail supervision")
    p.add_argument("--inject-preempt-round", default=None, type=int,
                   metavar="N",
                   help="set FL_PREEMPT_AT_ROUND=N in the child env "
                        "(deterministic preempt/resume drill)")
    if argv is None:
        argv = sys.argv[1:]
    if "--" in argv:
        split = argv.index("--")
        opts, child = p.parse_args(argv[:split]), argv[split + 1:]
    else:
        opts, child = p.parse_known_args(argv)
    if not child:
        p.error("no child args given (separate them with '--')")
    return Supervisor(opts, child).supervise()


if __name__ == "__main__":
    raise SystemExit(main())
