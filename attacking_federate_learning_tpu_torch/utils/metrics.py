"""Structured run metrics, the event schema, and logging.

The port's copy of the JAX package's ``utils/metrics.py``: the reference
logs through a print/file tee (reference main.py:13-18), a config dump
(main.py:19), accuracy lines every TEST_STEP rounds (main.py:77-80) and
a CSV of the accuracy trajectory whose filename encodes the
hyperparameters (main.py:100).  :class:`RunLogger` keeps all of those
and adds the versioned JSONL event log, validated at the emitter so a
malformed event fails the run that produced it.

Event contract: one JSON object per line with a ``kind`` from
:data:`EVENT_KINDS`, that kind's required fields, a schema version
``v`` and a relative timestamp ``t``; extra fields are allowed.  The
table is the JAX package's schema v14 kind for kind, so the JAX
package's readers (``iter_events``, ``tools/check_events.py``, the
registry) read a port run's log unchanged.  The port emits ``eval``,
``asr``, ``fault`` (in hierarchical rounds with the v13 fields
``shard_alive``, ``shards_dead``, ``shards_alive`` and ``tier2_action``),
``async`` (one a round in async rounds), ``traffic``, ``secagg``,
``heartbeat``, ``lifecycle`` and ``registry`` events, and the
observatories' (core/engine.py): ``round`` (--round-stats), ``defense``,
``attack``, ``shard_selection`` (v6) and the end-of-run
``selection_hist`` (--telemetry), ``margin`` (v12, --margins) and
``numerics`` (v14, --numerics), each a round; ``compile``, ``cost``,
``stage_cost`` and ``wire_bytes`` (--cost-report), ``profile``
(--profile), ``wall`` (--profile-every) and ``stream`` (host
streaming); ``forensics`` (report.py ``report forensics --events``) and
``campaign`` (campaigns/scheduler.py).  ``gate`` is written by the JAX
package's gates alone.
Readers accept every version; a newer-only kind stamped with an older
version is an emitter bug, rejected (``KIND_MIN_VERSION``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Callable, Optional

import numpy as np


SCHEMA_VERSION = 14
SUPPORTED_VERSIONS = tuple(range(1, SCHEMA_VERSION + 1))

# kind -> required fields (the JAX package's schema v14).
EVENT_KINDS = {
    # per-round scalar diagnostics (--round-stats)
    "round": {"round"},
    # eval-cadence accuracy line (reference main.py:77-80, structured)
    "eval": {"round", "test_loss", "accuracy", "correct", "test_size"},
    # backdoor attack-success rate at eval cadence
    "asr": {"round", "attack_success_rate"},
    # phase timing summary written once at run end (--profile)
    "profile": {"phases"},
    # host-stream stall accounting
    "stream": {"stream_stall_s", "stream_gets"},
    # per-round defense forensics (--telemetry)
    "defense": {"round", "defense"},
    # per-round attack envelope stats (--telemetry)
    "attack": {"round", "attack"},
    # end-of-run selection histogram
    "selection_hist": {"defense", "counts"},
    # fault-injection / recovery accounting (core/faults.py + the
    # engine's divergence watchdog): per-round injected/quarantined
    # counts, and rollback records (rolled_back, restored_round)
    "fault": {"round"},
    # --- v2 ---------------------------------------------------------------
    "compile": {"name", "compile_s", "cache"},
    "cost": {"name", "flops", "bytes_accessed", "peak_bytes"},
    # RunLogger liveness thread (round / rounds-per-sec EMA ride along)
    "heartbeat": {"rss_mb", "last_event_age_s"},
    # --- v3: the run lifecycle (utils/lifecycle.py) -------------------------
    # 'phase': start/resume/preempt/complete from the engine, fatal from
    # the CLI, retry/degrade/... from the JAX package's supervisor
    "lifecycle": {"phase"},
    # --- v4: the cross-run registry (utils/registry.py) ---------------------
    # the engine's run-finish stamp: the join key between a log and
    # runs/index.jsonl, with the trajectory summary riding along
    "registry": {"run_id"},
    "gate": {"cell", "status"},
    # --- v7: asynchronous buffered rounds (core/async_rounds.py): one a
    # round, the counts, the staleness histogram and the weight mass
    "async": {"round", "delivered"},
    # --- v5 .. v14 -----------------------------------------------------------
    "secagg": {"round"},
    "shard_selection": {"round", "defense"},
    "forensics": {"verdict"},
    "campaign": {"campaign", "phase"},
    "stage_cost": {"name", "stages", "coverage"},
    "wire_bytes": {"topology", "seams", "total_bytes"},
    "wall": {"name", "source", "wall_s"},
    "traffic": {"round", "arrived", "action"},
    "margin": {"round", "defense"},
    "numerics": {"round", "defense"},
}

# Minimum schema version per kind introduced after v1.
KIND_MIN_VERSION = {"compile": 2, "cost": 2, "heartbeat": 2,
                    "lifecycle": 3, "registry": 4, "gate": 4,
                    "secagg": 5, "shard_selection": 6, "forensics": 6,
                    "async": 7, "campaign": 8,
                    "stage_cost": 9, "wire_bytes": 9,
                    "wall": 10, "traffic": 11, "margin": 12,
                    "numerics": 14}


def validate_event(rec) -> dict:
    """Validate one event against the schema; returns it or raises
    ValueError.  Unknown kinds, unknown schema versions and missing
    required fields are errors; extra fields are not."""
    if not isinstance(rec, dict):
        raise ValueError(
            f"event must be a JSON object, got {type(rec).__name__}")
    v = rec.get("v", SCHEMA_VERSION)
    if v not in SUPPORTED_VERSIONS:
        # Version first: a newer writer's kinds would otherwise be
        # misdiagnosed as unknown.
        raise ValueError(
            f"unsupported event schema version {v!r} (this reader "
            f"speaks v{min(SUPPORTED_VERSIONS)}..v{max(SUPPORTED_VERSIONS)}"
            f"; a newer writer's logs need a newer reader)")
    kind = rec.get("kind")
    if kind not in EVENT_KINDS:
        raise ValueError(
            f"unknown event kind {kind!r} (schema v{SCHEMA_VERSION}; "
            f"known: {sorted(EVENT_KINDS)})")
    min_v = KIND_MIN_VERSION.get(kind, 1)
    if v < min_v:
        raise ValueError(
            f"{kind!r} events need schema v{min_v}, but this one is "
            f"stamped v{v} (emitter bug: a v{v} writer cannot produce "
            f"this kind)")
    missing = EVENT_KINDS[kind] - rec.keys()
    if missing:
        raise ValueError(
            f"{kind!r} event missing required fields {sorted(missing)}")
    if "round" in EVENT_KINDS[kind] and not isinstance(
            rec["round"], (int, float)):
        raise ValueError(
            f"{kind!r} event field 'round' must be numeric, "
            f"got {rec['round']!r}")
    return rec


def iter_events(path, validate: bool = True, skip_bad: bool = False,
                bad_lines: Optional[list] = None):
    """Yield events from a run JSONL, optionally schema-validated.
    Raises ValueError (with the line number) on a malformed line unless
    ``skip_bad``, in which case bad lines are skipped and appended to
    ``bad_lines`` as (lineno, message)."""
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                if skip_bad:
                    if bad_lines is not None:
                        bad_lines.append((lineno, f"not JSON: {e}"))
                    continue
                raise ValueError(f"{path}:{lineno}: not JSON: {e}") from e
            if validate:
                try:
                    validate_event(rec)
                except ValueError as e:
                    if skip_bad:
                        if bad_lines is not None:
                            bad_lines.append((lineno, str(e)))
                        continue
                    raise ValueError(f"{path}:{lineno}: {e}") from e
            yield rec


def _rss_mb() -> float:
    """Resident set size in MB via /proc; 0.0 where /proc is absent."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0
    except (OSError, ValueError, IndexError):
        pass
    return 0.0


class RunLogger:
    """Tee + CSV + structured JSONL sink; a context manager.

    ``with RunLogger(cfg) as logger:`` closes the JSONL handle and writes
    the accuracy CSV even when the run raises.  ``finish()`` (CSV + JSONL
    close) is idempotent and leaves the tee open for trailing summary
    lines; ``close()`` / ``__exit__`` shut everything.

    ``heartbeat_every > 0`` starts a daemon thread that appends a
    'heartbeat' event every N seconds (last-seen round, a rounds/s EMA,
    resident set size, the age of the last real event).  Heartbeats
    never update the last-event clock, so a stalled run shows as a
    growing age.  Every JSONL write goes through ``_write_lock``: the
    beat thread shares the handle.

    ``log_dir=None`` writes no files: no JSONL and no CSV; events are
    validated as always and kept in ``events`` (a list), and lines go to
    ``log`` unless ``output`` tees them.  ``FederatedExperiment.run(
    log=...)`` logs through such a logger."""

    def __init__(self, config, output: Optional[str] = None,
                 log_dir: Optional[str] = "logs",
                 jsonl_name: Optional[str] = None,
                 heartbeat_every: float = 0.0,
                 log: Callable[[str], None] = print):
        self.config = config
        self.output = output
        self.log_dir = log_dir
        self.log = log
        self.events: list = []
        self.jsonl_path = None
        self._jsonl = None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            base = jsonl_name or config.csv_name().replace(".csv", "")
            self.jsonl_path = os.path.join(log_dir, base + ".jsonl")
            self._jsonl = open(self.jsonl_path, "a")
        # Reference-style tee (main.py:13-18), opened once and kept.
        self._tee = open(self.output, "a") if self.output else None
        self._finished = False
        self.accuracies: list = []
        self.accuracies_epochs: list = []
        self._t0 = time.time()
        self._write_lock = threading.Lock()
        self._last_event_time = time.time()
        self._last_round = None
        self._last_round_time = None
        self._rps_ema = None
        self._hb_stop = None
        self._hb_thread = None
        if heartbeat_every and heartbeat_every > 0:
            self._start_heartbeat(float(heartbeat_every))

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False

    def print(self, s, end="\n"):
        if self._tee is not None:
            self._tee.write(str(s) + end)
            self._tee.flush()
        elif self.log is print:
            print(s, end=end, flush=True)
        else:
            self.log(str(s) if end == "\n" else str(s) + end)

    def dump_config(self):
        self.print(dataclasses.asdict(self.config))

    # --- heartbeat ----------------------------------------------------------
    def _start_heartbeat(self, every: float):
        self._hb_stop = threading.Event()

        def beat():
            while not self._hb_stop.wait(every):
                if self._finished:
                    return
                try:
                    self.record(**self.heartbeat_fields())
                except ValueError:
                    return      # closed mid-beat; the stop flag races
        self._hb_thread = threading.Thread(
            target=beat, name="runlogger-heartbeat", daemon=True)
        self._hb_thread.start()

    def heartbeat_fields(self) -> dict:
        """One heartbeat payload (callable without the thread too)."""
        now = time.time()
        rec = dict(kind="heartbeat",
                   rss_mb=round(_rss_mb(), 1),
                   last_event_age_s=round(now - self._last_event_time, 3))
        if self._last_round is not None:
            rec["round"] = self._last_round
        if self._rps_ema is not None:
            rec["rounds_per_s"] = round(self._rps_ema, 4)
        return rec

    def _note_progress(self, fields):
        """Any non-heartbeat event resets the stall clock; one with a
        numeric 'round' advances the last-seen round and the EMA."""
        if fields.get("kind") == "heartbeat":
            return
        now = time.time()
        self._last_event_time = now
        rnd = fields.get("round")
        if not isinstance(rnd, (int, float)):
            return
        if (self._last_round is not None and rnd > self._last_round
                and now > self._last_round_time):
            rps = (rnd - self._last_round) / (now - self._last_round_time)
            self._rps_ema = (rps if self._rps_ema is None
                             else 0.3 * rps + 0.7 * self._rps_ema)
        if self._last_round is None or rnd >= self._last_round:
            self._last_round = rnd
            self._last_round_time = now

    # --- structured records -------------------------------------------------
    def record(self, **fields):
        fields.setdefault("t", round(time.time() - self._t0, 3))
        if "kind" in fields:
            fields.setdefault("v", SCHEMA_VERSION)
            validate_event(fields)
        with self._write_lock:
            if self._finished:
                # The beat thread can race finish().
                raise ValueError("record() after finish()")
            self._note_progress(fields)
            if self._jsonl is None:
                self.events.append(fields)
                return
            self._jsonl.write(json.dumps(fields, default=float) + "\n")
            self._jsonl.flush()

    def record_eval(self, epoch, test_loss, correct, test_size, asr=None,
                    **extra):
        accuracy = 100.0 * float(correct) / test_size
        self.accuracies.append(accuracy)
        self.accuracies_epochs.append(epoch)
        # Line format of reference main.py:77-80.
        self.print("Test set: [{:3d}] Average loss: {:.4f}, "
                   "Accuracy: {}/{} ({:.2f}%)".format(
                       epoch, float(test_loss), int(correct), test_size,
                       accuracy))
        rec = dict(kind="eval", round=epoch, test_loss=float(test_loss),
                   accuracy=accuracy, correct=int(correct),
                   test_size=test_size, **extra)
        if asr is not None:
            rec["attack_success_rate"] = float(asr)
        self.record(**rec)
        return accuracy

    def finish(self):
        """Stop the heartbeat, close the JSONL, print the max accuracy and
        write the CSV.  Idempotent; the tee stays open until close()."""
        if self._finished:
            return
        if self._hb_stop is not None:
            self._hb_stop.set()
        with self._write_lock:
            if self._finished:
                return
            self._finished = True
            if self._jsonl is not None:
                self._jsonl.close()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2.0)
        if self.accuracies:
            self.print("Max accuracy: {}".format(max(self.accuracies)))
        if self.accuracies and self.log_dir is not None:
            # CSV with the reference's filename schema (main.py:100).
            np.savetxt(os.path.join(self.log_dir, self.config.csv_name()),
                       np.asarray(self.accuracies), delimiter=",")

    def close(self):
        self.finish()
        if self._tee is not None and not self._tee.closed:
            self._tee.close()

