"""Cross-run registry, writer side: the run-finish stamp.

The port's copy of the part of the JAX package's ``utils/registry.py``
that its engine calls when a journaled run completes: one entry per run
(manifest summary, journal high-water mark, event-log rollups) appended
to ``runs/index.jsonl``.  The JAX package's ``RunRegistry(run_dir)``
reads that index (``resolve``, ``runs list/show/diff``), so a finished
port run is found by its run id.  The readers, ``refresh``, the bench
and progress sidecars and the checkpoint migration are not ported.
"""

from __future__ import annotations

import json
import os
from typing import Optional


INDEX_NAME = "index.jsonl"

# Manifest/journal filenames (utils/lifecycle.py layout).
_MANIFEST = "manifest.json"
_JOURNAL = "journal.jsonl"

# Entry fields promoted out of the stored config for filtering.
_CONFIG_KEYS = ("dataset", "defense", "seed", "epochs", "batch_size",
                "partition")


def _stat_sig(*paths) -> str:
    """mtime+size signature over the artifacts backing one entry (the
    JAX package's refresh re-ingests a run when it changes)."""
    parts = []
    for p in paths:
        try:
            st = os.stat(p)
            parts.append(f"{st.st_mtime_ns}:{st.st_size}")
        except OSError:
            parts.append("-")
    return ";".join(parts)


def _read_json(path) -> Optional[dict]:
    """A torn or absent file is None, never a crash."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def _iter_jsonl(path):
    """Yield (record, None) per parseable line and (None, lineno) per
    torn one."""
    try:
        f = open(path)
    except OSError:
        return
    with f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line), None
            except json.JSONDecodeError:
                yield None, lineno


class RunRegistry:
    """The index over one ``run_dir`` (default ``runs/``), written by
    :meth:`stamp`."""

    def __init__(self, run_dir: str = "runs"):
        self.run_dir = run_dir
        self.index_path = os.path.join(run_dir, INDEX_NAME)

    def stamp(self, entry: dict):
        """Append one entry.  Append-only, so concurrent finishers keep
        each other's stamps; readers take the last entry per run_id."""
        if "run_id" not in entry:
            raise ValueError("registry entry needs a run_id")
        os.makedirs(self.run_dir, exist_ok=True)
        with open(self.index_path, "a") as f:
            f.write(json.dumps(entry, default=str) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def _journal_rollup(self, d: str) -> dict:
        """High-water mark and eval/attempt counts from the raw journal
        (the manifest may be stale or torn)."""
        high, evals, attempts, torn = -1, set(), 0, 0
        for rec, bad in _iter_jsonl(os.path.join(d, _JOURNAL)):
            if rec is None:
                torn += 1
                continue
            k = rec.get("kind")
            if k == "rounds":
                try:
                    high = max(high, int(rec["end"]))
                except (KeyError, TypeError, ValueError):
                    torn += 1
            elif k == "eval":
                evals.add(rec.get("round"))
            elif k == "attempt":
                attempts = max(attempts, int(rec.get("attempt", 0)))
        return {"journal_high": high, "evals_committed": len(evals),
                "attempts": attempts, "torn_lines": torn}

    def _events_rollup(self, events_path: str) -> dict:
        """Per-kind counts, trajectory endpoints and compile-cache and
        fault tallies of a run's event log (a torn line is counted)."""
        kinds = {}
        final_acc = max_acc = final_asr = None
        cache_hits = cache_misses = fault_rounds = 0
        torn = 0
        for rec, bad in _iter_jsonl(events_path):
            if rec is None:
                torn += 1
                continue
            k = rec.get("kind")
            if k is None:
                continue
            kinds[k] = kinds.get(k, 0) + 1
            if k == "eval":
                acc = rec.get("accuracy")
                if isinstance(acc, (int, float)):
                    final_acc = acc
                    max_acc = acc if max_acc is None else max(max_acc, acc)
            elif k == "asr":
                asr = rec.get("attack_success_rate")
                if isinstance(asr, (int, float)):
                    final_asr = asr
            elif k == "compile":
                cache = rec.get("cache")
                cache_hits += cache == "hit"
                cache_misses += cache == "miss"
            elif k == "fault":
                fault_rounds += 1
        out = {"event_kinds": kinds, "event_torn_lines": torn}
        if final_acc is not None:
            out["final_accuracy"] = round(final_acc, 4)
            out["max_accuracy"] = round(max_acc, 4)
        if final_asr is not None:
            out["final_asr"] = round(final_asr, 4)
        if cache_hits or cache_misses:
            out["cache_hits"] = cache_hits
            out["cache_misses"] = cache_misses
        if fault_rounds:
            out["fault_rounds"] = fault_rounds
        return out

    def _entry_for_run(self, run_id: str) -> dict:
        """The index entry of ``runs/<run_id>/``: the JAX package's
        entry for a run, field for field (no checkpoint migration)."""
        d = os.path.join(self.run_dir, run_id)
        manifest = _read_json(os.path.join(d, _MANIFEST)) or {}
        entry = {"run_id": run_id, "source": "run", "dir": d}
        for k in ("status", "attempt", "last_round", "rounds_committed",
                  "updated", "exit_code", "checkpoint", "events",
                  "final_accuracy", "max_accuracy", "final_asr",
                  "rounds_per_s", "config_hash", "tag"):
            if k in manifest:
                entry[k] = manifest[k]
        cfg = manifest.get("config")
        if isinstance(cfg, dict):
            for k in _CONFIG_KEYS:
                if k in cfg:
                    entry[k] = cfg[k]
        if not manifest:
            entry["problems"] = ["manifest missing or torn"]
        entry.update(self._journal_rollup(d))
        ev = entry.get("events")
        if isinstance(ev, str) and os.path.exists(ev):
            entry.update(self._events_rollup(ev))
        entry["sig"] = _stat_sig(os.path.join(d, _MANIFEST),
                                 os.path.join(d, _JOURNAL))
        return entry
