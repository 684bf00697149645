"""Preemption-safe run lifecycle: graceful shutdown, the per-run
journal, and the failure taxonomy.

The port's copy of the JAX package's ``utils/lifecycle.py``, host-side
Python throughout:

- :class:`GracefulShutdown`: SIGTERM/SIGINT set a flag; the engine polls
  it at its host boundaries (``core/engine.py``), writes an
  auto-checkpoint, flushes the event log and raises :class:`Preempted`,
  which the CLI maps to :data:`EXIT_PREEMPTED` (75, ``EX_TEMPFAIL``:
  resumable).  A second signal while the first is being honored restores
  the default disposition and re-delivers it.
- :class:`RunJournal`: an append-only ``journal.jsonl`` and an atomically
  rewritten ``manifest.json`` under ``runs/<run_id>/``.  Rounds and evals
  are committed at host boundaries under a monotonic high-water mark, so
  re-executed rounds (after ``--resume`` or a watchdog rollback) are
  never counted twice and their events never emitted twice.
  ``verify()`` checks that invariant.
- :func:`classify_failure`: the supervisor's failure taxonomy.

Durability: journal appends are flushed and fsync'd (at host boundaries,
not every round); the manifest goes through a same-directory temporary
file and ``os.replace``.  A kill mid-append leaves at most one torn line,
which the next attempt seals and the reader skips.

The files are the JAX package's: either package's ``RunJournal.verify``
and registry (utils/registry.py) read either package's journals.  Run
ids are not shared: :func:`run_id_for` hashes the port's own config,
which lacks two of the JAX config's fields, so one experiment gets
another id in each package (pin ``--run-id`` to share one).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import signal
import time
from typing import Optional


# Process exit codes (the supervisor's first classification key).
EXIT_OK = 0
EXIT_PREEMPTED = 75   # EX_TEMPFAIL: checkpointed + resumable, retry now
EXIT_DIVERGED = 76    # watchdog exhausted max_rollbacks: deterministic,
#                       retrying the same config would diverge again


class Preempted(Exception):
    """A graceful-shutdown request was honored at a host boundary: the
    state is checkpointed, the manifest says 'preempted', and the
    process should exit EXIT_PREEMPTED."""

    def __init__(self, round_: int, source: str):
        self.round = int(round_)
        self.source = source
        super().__init__(
            f"preempted by {source} at round boundary {round_} "
            f"(state checkpointed; resume with --resume)")


class GracefulShutdown:
    """Signal-driven shutdown request, polled at the engine's host boundaries.

    A handler does not interrupt a round in flight (a torn round is
    worthless), so SIGTERM/SIGINT only *request*:
    the engine honors the request at the next host boundary — the same
    boundary where checkpoints and eval already live — by
    checkpointing and raising :class:`Preempted`.

    ``preempt_at_round``: deterministic injection seam for tests and
    drills (env ``FL_PREEMPT_AT_ROUND`` via the CLI): the request fires at the first boundary at or past
    that round, but only when the attempt *started* at or before it —
    so the resumed attempt (which starts past the injection point)
    runs to completion instead of re-preempting forever.
    """

    def __init__(self, preempt_at_round: Optional[int] = None,
                 signals=(signal.SIGTERM, signal.SIGINT)):
        self.preempt_at_round = preempt_at_round
        self.signals = tuple(signals)
        self.requested = False
        self.source = None
        self._old = {}

    # --- installation ---------------------------------------------------
    def install(self):
        for s in self.signals:
            self._old[s] = signal.signal(s, self._on_signal)
        return self

    def restore(self):
        for s, old in self._old.items():
            signal.signal(s, old)
        self._old = {}

    __enter__ = install

    def __exit__(self, exc_type, exc, tb):
        self.restore()
        return False

    def _on_signal(self, signum, frame):
        if self.requested:
            # Second signal: the user means NOW.  Restore the default
            # disposition and re-deliver — no graceful anything.
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)
            return
        self.requested = True
        self.source = signal.Signals(signum).name

    # --- the boundary poll ----------------------------------------------
    def should_preempt(self, start_round: int, round_: int) -> bool:
        """True when the engine should checkpoint-and-exit at this
        boundary (``round_`` just finished; the attempt resumed from
        ``start_round``)."""
        if self.requested:
            return True
        pa = self.preempt_at_round
        if pa is not None and start_round <= pa <= round_:
            self.source = self.source or "injected"
            return True
        return False


# ---------------------------------------------------------------------------
# run identity

# Config fields that do not shape the trajectory or the run's identity —
# two runs differing only here are the SAME run to the journal.
_IDENTITY_EXCLUDED = ("output", "log_dir", "run_dir")


def run_id_for(cfg) -> str:
    """Deterministic run id: a restarted process (same config) finds the
    same journal.  The digest is of the port's ``ExperimentConfig``
    (77 of the JAX config's 79 fields: it lacks ``mesh_shape`` and
    ``backend``), so it differs from the JAX package's id for the same
    experiment; an explicit ``--run-id`` overrides it."""
    d = dataclasses.asdict(cfg)
    for k in _IDENTITY_EXCLUDED:
        d.pop(k, None)
    digest = hashlib.sha1(
        json.dumps(d, sort_keys=True, default=str).encode()).hexdigest()
    return f"{cfg.dataset}_{cfg.defense}_s{cfg.seed}_{digest[:10]}"


# ---------------------------------------------------------------------------
# the per-run journal


class RunJournal:
    """Append-only per-run journal + atomic resume manifest.

    Layout (``<run_dir>/<run_id>/``):

    - ``journal.jsonl`` — one record per committed unit, append-only:
      ``{"kind": "attempt", "attempt": k, "from_round": r}``,
      ``{"kind": "rounds", "start": s, "end": e}`` (inclusive),
      ``{"kind": "eval", "round": t}``,
      ``{"kind": "finish", "status": ..., "exit_code": ...}``.
    - ``manifest.json`` — the current lifecycle summary, atomically
      replaced at every transition (what the supervisor reads).

    Exactly-once semantics: ``commit_rounds`` clamps below the
    monotonic high-water mark, so a round enters the journal at most
    once no matter how many times it is re-executed (resume replay and
    watchdog rollback both re-execute); ``fresh_round``/``fresh_eval``
    gate event emission and eval work with the same mark, so the event
    stream matches.  Records are committed *after* the work they
    describe: a kill between execution and commit re-executes (and
    then commits) on resume — never double-commits.
    """

    def __init__(self, run_dir: str, run_id: str):
        self.run_id = run_id
        self.dir = os.path.join(run_dir, run_id)
        os.makedirs(self.dir, exist_ok=True)
        self.journal_path = os.path.join(self.dir, "journal.jsonl")
        self.manifest_path = os.path.join(self.dir, "manifest.json")
        self._fh = None
        self.high = -1          # highest committed round
        self.evals = set()      # committed eval rounds
        self.attempt = 0        # attempts so far (this one after start_attempt)
        self.torn_lines = 0
        self._replay()

    # --- replay ----------------------------------------------------------
    def records(self) -> list:
        """All parseable journal records (torn lines skipped)."""
        if not os.path.exists(self.journal_path):
            return []
        out, torn = [], 0
        with open(self.journal_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    # A SIGKILL mid-append leaves one torn line; the
                    # append path seals it with a newline so it can
                    # never swallow a later record.
                    torn += 1
        self.torn_lines = torn
        return out

    def _replay(self):
        for rec in self.records():
            k = rec.get("kind")
            if k == "rounds":
                self.high = max(self.high, int(rec["end"]))
            elif k == "eval":
                self.evals.add(int(rec["round"]))
            elif k == "attempt":
                self.attempt = max(self.attempt, int(rec["attempt"]))

    # --- append path ------------------------------------------------------
    def _append(self, rec: dict):
        if self._fh is None:
            # Seal a torn tail before appending: without the newline a
            # new record would concatenate onto the partial line and
            # both would be unreadable.
            if (os.path.exists(self.journal_path)
                    and os.path.getsize(self.journal_path) > 0):
                with open(self.journal_path, "rb") as f:
                    f.seek(-1, os.SEEK_END)
                    needs_seal = f.read(1) != b"\n"
                if needs_seal:
                    with open(self.journal_path, "a") as f:
                        f.write("\n")
            self._fh = open(self.journal_path, "a")
        rec.setdefault("t", round(time.time(), 3))
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        os.fsync(self._fh.fileno())

    # --- lifecycle transitions -------------------------------------------
    def start_attempt(self, resume_round: int) -> int:
        """Record the start of one process attempt; returns the attempt
        number (1-based)."""
        self.attempt += 1
        self._append({"kind": "attempt", "attempt": self.attempt,
                      "from_round": int(resume_round)})
        self.write_manifest("running")
        return self.attempt

    def finish(self, status: str, exit_code: int = EXIT_OK, **extra):
        self._append({"kind": "finish", "status": status,
                      "exit_code": int(exit_code)})
        self.write_manifest(status, exit_code=int(exit_code), **extra)

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # --- exactly-once accounting -----------------------------------------
    def fresh_round(self, t: int) -> bool:
        """True when round ``t`` has not been committed yet — the gate
        for per-round event emission (a replayed round's events were
        already written by the attempt that committed it)."""
        return int(t) > self.high

    def commit_rounds(self, start: int, end: int):
        """Commit rounds [start, end] (inclusive), clamped to the fresh
        suffix; re-executions below the high-water mark are no-ops."""
        start = max(int(start), self.high + 1)
        if int(end) < start:
            return
        self._append({"kind": "rounds", "start": start, "end": int(end)})
        self.high = int(end)

    def fresh_eval(self, t: int) -> bool:
        return int(t) not in self.evals

    def commit_eval(self, t: int):
        if not self.fresh_eval(t):
            return
        self._append({"kind": "eval", "round": int(t)})
        self.evals.add(int(t))

    # --- manifest ---------------------------------------------------------
    def write_manifest(self, status: str, **extra):
        man = {"run_id": self.run_id, "status": status,
               "attempt": self.attempt, "last_round": self.high,
               "rounds_committed": self.high + 1,
               "evals_committed": len(self.evals),
               "torn_lines": self.torn_lines,
               "updated": round(time.time(), 3)}
        man.update(extra)
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(man, f, indent=1, default=str)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.manifest_path)

    def read_manifest(self) -> Optional[dict]:
        if not os.path.exists(self.manifest_path):
            return None
        with open(self.manifest_path) as f:
            return json.load(f)

    # --- the invariant, checked mechanically ------------------------------
    def verify(self, epochs: Optional[int] = None,
               test_step: Optional[int] = None) -> list:
        """Exactly-once audit; returns a list of problem strings (empty
        = clean).  With ``epochs``, coverage of [0, epochs) is required;
        with ``test_step`` too, the eval set must be exactly the eval
        cadence (every test_step-th round plus the final one)."""
        problems = []
        seen_rounds = {}
        evals = {}
        for rec in self.records():
            if rec.get("kind") == "rounds":
                for t in range(int(rec["start"]), int(rec["end"]) + 1):
                    seen_rounds[t] = seen_rounds.get(t, 0) + 1
            elif rec.get("kind") == "eval":
                t = int(rec["round"])
                evals[t] = evals.get(t, 0) + 1
        dup_r = sorted(t for t, c in seen_rounds.items() if c > 1)
        if dup_r:
            problems.append(f"rounds committed more than once: {dup_r}")
        dup_e = sorted(t for t, c in evals.items() if c > 1)
        if dup_e:
            problems.append(f"evals committed more than once: {dup_e}")
        if epochs is not None:
            missing = [t for t in range(epochs) if t not in seen_rounds]
            if missing:
                problems.append(f"rounds never committed: {missing}")
            stray = sorted(t for t in seen_rounds if not 0 <= t < epochs)
            if stray:
                problems.append(f"rounds outside [0, {epochs}): {stray}")
            if test_step is not None:
                want = {t for t in range(epochs)
                        if t % test_step == 0 or t == epochs - 1}
                if set(evals) != want:
                    problems.append(
                        f"eval set mismatch: got {sorted(evals)}, "
                        f"want {sorted(want)}")
        return problems


# ---------------------------------------------------------------------------
# failure taxonomy (the JAX package's supervisor, tools/supervisor.py)

_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
                "MemoryError", "std::bad_alloc", "OOM when allocating")
_BACKEND_MARKERS = ("Unable to initialize backend",
                    "failed to connect", "Connection refused",
                    "DEADLINE_EXCEEDED", "UNAVAILABLE",
                    "relay", "socket closed",
                    "TPU initialization failed")
_DIVERGENCE_MARKERS = ("diverged", "exhausted", "FloatingPointError")


def classify_failure(returncode: int, stderr_tail: str = "",
                     stalled: bool = False) -> str:
    """Map one child run's outcome to a failure class.

    Precedence: a supervisor-detected stall (heartbeat age beyond the
    stall timeout — the child was killed BY the supervisor, so its exit
    code describes the kill, not the disease) wins over everything;
    then the explicit lifecycle exit codes; then stderr markers (OOM
    before backend: an OOM abort often drags connection noise behind
    it); anything else is a plain crash."""
    if returncode == EXIT_OK:
        return "done"
    if stalled:
        return "stall"
    if returncode == EXIT_PREEMPTED:
        return "preempted"
    if returncode == EXIT_DIVERGED:
        return "divergence"
    tail = stderr_tail or ""
    if any(m in tail for m in _OOM_MARKERS):
        return "oom"
    if any(m in tail for m in _BACKEND_MARKERS):
        return "backend"
    if any(m in tail for m in _DIVERGENCE_MARKERS):
        return "divergence"
    return "crash"
