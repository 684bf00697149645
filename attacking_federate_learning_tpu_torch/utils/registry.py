"""Cross-run registry: a queryable index over ``runs/``.

The port's copy of the JAX package's ``utils/registry.py``, both halves:

- :class:`RunRegistry` indexes every ``runs/<run_id>/`` journal dir
  (manifest, journal high-water mark, event-log rollups) plus
  BENCH_*.json / PROGRESS.jsonl sidecar artifacts into one
  ``runs/index.jsonl``;
- ``refresh()`` is incremental (a per-source ``sig`` of mtime and size
  skips unchanged runs) and tolerant of torn artifacts (a SIGKILL
  mid-write leaves at most one unparseable line or file; it is counted,
  never fatal);
- ``resolve()`` finds a run by exact id, unique id prefix, tag, or
  ``key=value`` config filter: ``runs list/show/diff/compare`` and
  ``report --run-id`` resolve through it;
- ``stamp()`` is the engine's run-finish hook (core/engine.py): one
  appended index line, so a finished run is queryable at once.

The index format is the JAX package's, so a ``runs/`` directory holding
runs of either package (or both) reads alike through either registry.
Readers take the LAST entry per run_id, and ``refresh()`` compacts.
One-shot migration (the JAX package's layout fix): a manifest whose
``checkpoint`` names a rotated ``checkpoint-auto-*`` file still in the
shared legacy ``runs/<dataset>/`` dir gets that file moved under the
owning ``runs/<run_id>/``; a manifest naming anything else (a port run's
own checkpoints already live there) is never rewritten.
"""

from __future__ import annotations

import glob as _glob
import json
import os
from typing import Optional


INDEX_NAME = "index.jsonl"

# Manifest/journal filenames (utils/lifecycle.py layout).
_MANIFEST = "manifest.json"
_JOURNAL = "journal.jsonl"

# Entry fields promoted out of the stored config for filtering without
# opening the manifest.
_CONFIG_KEYS = ("dataset", "defense", "seed", "epochs", "batch_size",
                "partition")


def _stat_sig(*paths) -> str:
    """mtime+size signature over the artifacts backing one entry; a
    changed file changes the sig, so refresh re-ingests exactly the
    runs that moved."""
    parts = []
    for p in paths:
        try:
            st = os.stat(p)
            parts.append(f"{st.st_mtime_ns}:{st.st_size}")
        except OSError:
            parts.append("-")
    return ";".join(parts)


def _read_json(path) -> Optional[dict]:
    """Tolerant JSON read: a torn/absent file is None, never a crash
    (the registry must index a run store that a SIGKILL is actively
    mutating)."""
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
    """Queryable index over one ``run_dir`` (default ``runs/``)."""

    def __init__(self, run_dir: str = "runs"):
        self.run_dir = run_dir
        self.index_path = os.path.join(run_dir, INDEX_NAME)
        self._migrations = 0    # moves performed by the current refresh

    # --- index io ---------------------------------------------------------
    def _load_index(self) -> dict:
        """{run_id: entry}, last entry per run_id wins (stamp() appends;
        refresh() compacts); torn lines skipped."""
        out = {}
        for rec, torn in _iter_jsonl(self.index_path):
            if rec is not None and isinstance(rec, dict) and "run_id" in rec:
                out[rec["run_id"]] = rec
        return out

    def _write_index(self, entries: dict):
        os.makedirs(self.run_dir, exist_ok=True)
        tmp = self.index_path + ".tmp"
        with open(tmp, "w") as f:
            for rid in sorted(entries):
                f.write(json.dumps(entries[rid], default=str) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.index_path)

    def stamp(self, entry: dict):
        """Append one entry (engine run-finish hook).  Append-only so
        concurrent finishers can't lose each other's stamps; readers
        take the last entry per run_id and refresh() compacts."""
        if "run_id" not in entry:
            raise ValueError("registry entry needs a run_id")
        os.makedirs(self.run_dir, exist_ok=True)
        with open(self.index_path, "a") as f:
            f.write(json.dumps(entry, default=str) + "\n")
            f.flush()
            os.fsync(f.fileno())

    # --- ingestion --------------------------------------------------------
    def _run_dirs(self):
        """Journal dirs under run_dir: anything carrying a manifest or a
        journal.  Dataset checkpoint dirs (runs/<dataset>/ — the
        reference layout, checkpoint files only) are not runs."""
        try:
            names = sorted(os.listdir(self.run_dir))
        except OSError:
            return []
        out = []
        for n in names:
            d = os.path.join(self.run_dir, n)
            if not os.path.isdir(d):
                continue
            if (os.path.exists(os.path.join(d, _MANIFEST))
                    or os.path.exists(os.path.join(d, _JOURNAL))):
                out.append(n)
        return out

    def _journal_rollup(self, d: str) -> dict:
        """High-water mark + eval/attempt counts straight from the raw
        journal (the manifest may be stale or torn)."""
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
        """Per-kind counts + trajectory endpoints + compile-cache and
        fault/lifecycle tallies from a run's event log (tolerant: a torn
        line is counted, not fatal — the registry indexes logs that a
        crash truncated)."""
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

    def _migrate_checkpoint(self, run_id: str, d: str,
                            manifest: dict) -> Optional[str]:
        """One-shot layout migration: a manifest-referenced auto-
        checkpoint still in the shared legacy runs/<dataset>/ dir moves
        under the owning runs/<run_id>/ (npz + json sidecar), and the
        manifest is rewritten to point there.  Only the file the
        manifest itself names is touched — that file is this run's by
        construction, so no other run's resume can lose it."""
        ck = manifest.get("checkpoint")
        if not isinstance(ck, str) or not os.path.basename(ck).startswith(
                "checkpoint-auto-"):
            return None
        src_dir = os.path.dirname(os.path.abspath(ck))
        if src_dir == os.path.abspath(d):
            return None                   # already owned
        dst = os.path.join(d, os.path.basename(ck))
        if not os.path.exists(ck) or os.path.exists(dst):
            return None
        os.replace(ck, dst)
        side = ck.replace(".npz", ".json")
        if os.path.exists(side):
            os.replace(side, dst.replace(".npz", ".json"))
        manifest["checkpoint"] = dst
        tmp = os.path.join(d, _MANIFEST + ".tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f, indent=1, default=str)
        os.replace(tmp, os.path.join(d, _MANIFEST))
        return dst

    def _entry_for_run(self, run_id: str, migrate: bool = False) -> dict:
        """The index entry of ``runs/<run_id>/``; ``migrate`` lets it
        move a legacy auto-checkpoint first (refresh does; the engine's
        run-finish stamp does not)."""
        d = os.path.join(self.run_dir, run_id)
        manifest = _read_json(os.path.join(d, _MANIFEST)) or {}
        entry = {"run_id": run_id, "source": "run", "dir": d}
        if migrate and manifest:
            moved = self._migrate_checkpoint(run_id, d, manifest)
            if moved:
                # Historical record (kept on reuse); the refresh
                # summary counts only moves performed in that pass.
                entry["migrated_checkpoint"] = moved
                self._migrations += 1
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

    def _entry_for_bench(self, path: str) -> dict:
        blob = _read_json(path) or {}
        # A bench harness's output wrapped as {"parsed": RESULT}, or a
        # raw RESULT dump at the root.
        parsed = blob.get("parsed") if isinstance(
            blob.get("parsed"), dict) else blob
        stem = os.path.splitext(os.path.basename(path))[0]
        entry = {"run_id": f"bench:{stem}", "source": "bench",
                 "path": path, "sig": _stat_sig(path)}
        if not blob:
            entry["problems"] = ["bench JSON missing or torn"]
            return entry
        for k in ("metric", "value", "unit", "valid", "env",
                  "phases_completed", "window_s", "run_ids"):
            if k in parsed:
                entry[k] = parsed[k]
        return entry

    def _entry_for_progress(self, path: str) -> dict:
        entry = {"run_id": f"progress:{os.path.basename(path)}",
                 "source": "progress", "path": path,
                 "sig": _stat_sig(path)}
        last, n, torn = None, 0, 0
        for rec, bad in _iter_jsonl(path):
            if rec is None:
                torn += 1
                continue
            last, n = rec, n + 1
        entry["lines"] = n
        entry["torn_lines"] = torn
        if last:
            entry["last"] = last
        return entry

    # --- refresh ----------------------------------------------------------
    def refresh(self, bench: Optional[list] = None,
                progress: Optional[list] = None,
                migrate: bool = True) -> dict:
        """Rebuild ``runs/index.jsonl`` incrementally.  ``bench`` /
        ``progress``: explicit sidecar artifact paths (globs accepted);
        unchanged sources (same sig) keep their previous entry without
        re-reading logs.  Returns a summary dict."""
        old = self._load_index()
        fresh, reused = {}, 0
        self._migrations = 0

        def take(key, build):
            prev = old.get(key)
            sig = build["sig_probe"]()
            if prev is not None and prev.get("sig") == sig:
                # Migration already ran when the entry was first built
                # (a moved checkpoint changes the manifest => the sig).
                fresh[key] = prev
                return False
            fresh[key] = build["make"]()
            return True

        built = 0
        for rid in self._run_dirs():
            d = os.path.join(self.run_dir, rid)
            built += take(rid, {
                "sig_probe": lambda d=d: _stat_sig(
                    os.path.join(d, _MANIFEST), os.path.join(d, _JOURNAL)),
                "make": lambda rid=rid: self._entry_for_run(rid, migrate)})
        for pat in (bench or []):
            for p in sorted(_glob.glob(pat)) or []:
                key = f"bench:{os.path.splitext(os.path.basename(p))[0]}"
                built += take(key, {
                    "sig_probe": lambda p=p: _stat_sig(p),
                    "make": lambda p=p: self._entry_for_bench(p)})
        for pat in (progress or []):
            for p in sorted(_glob.glob(pat)) or []:
                key = f"progress:{os.path.basename(p)}"
                built += take(key, {
                    "sig_probe": lambda p=p: _stat_sig(p),
                    "make": lambda p=p: self._entry_for_progress(p)})
        reused = len(fresh) - built
        self._write_index(fresh)
        return {"entries": len(fresh), "built": built, "reused": reused,
                "dropped": len(set(old) - set(fresh)),
                "migrated": self._migrations}

    # --- staleness --------------------------------------------------------
    def stale_run_ids(self) -> list:
        """Run ids whose manifest/journal changed AFTER the index was
        last written — the stale-index footgun: a reader that skips
        refresh() ('runs list --no-refresh', a cold 'runs campaign')
        would silently report outdated summaries.  Returns every run
        dir when the index does not exist yet."""
        try:
            idx_mtime = os.path.getmtime(self.index_path)
        except OSError:
            return self._run_dirs()
        stale = []
        for rid in self._run_dirs():
            d = os.path.join(self.run_dir, rid)
            for name in (_MANIFEST, _JOURNAL):
                try:
                    if os.path.getmtime(os.path.join(d, name)) > idx_mtime:
                        stale.append(rid)
                        break
                except OSError:
                    continue
        return stale

    # --- queries ----------------------------------------------------------
    def entries(self, filters=()) -> list:
        """Index entries (stable run_id order), optionally filtered by
        ``key=value`` strings compared against the stringified entry
        field (so ``seed=1`` and ``defense=Krum`` both work)."""
        out = list(self._load_index().values())
        out.sort(key=lambda e: str(e.get("run_id")))
        for flt in filters:
            if "=" not in flt:
                raise ValueError(f"filter must be key=value, got {flt!r}")
            k, v = flt.split("=", 1)
            out = [e for e in out if str(e.get(k)) == v]
        return out

    def resolve(self, query: str, filters=()) -> dict:
        """One entry by exact run_id, unique id prefix, or tag; raises
        ValueError naming the candidates on a miss or an ambiguity."""
        ents = self.entries(filters)
        by_id = {e["run_id"]: e for e in ents}
        if query in by_id:
            return by_id[query]
        pref = [e for e in ents if str(e["run_id"]).startswith(query)]
        if len(pref) == 1:
            return pref[0]
        tagged = [e for e in ents if e.get("tag") == query]
        if len(tagged) == 1:
            return tagged[0]
        cands = sorted(str(e["run_id"]) for e in (pref or tagged))
        if cands:
            raise ValueError(
                f"run {query!r} is ambiguous: {cands}")
        raise ValueError(
            f"no run matching {query!r} in {self.index_path} "
            f"({len(ents)} entries; refresh with 'runs list --refresh'?)")

    def tag(self, query: str, tag: str) -> dict:
        """Attach a human tag to a run (resolvable via resolve());
        persisted in both the index and the manifest so a refresh keeps
        it."""
        entry = self.resolve(query)
        entry["tag"] = tag
        man_path = os.path.join(entry.get("dir", ""), _MANIFEST)
        man = _read_json(man_path)
        if man is not None:
            man["tag"] = tag
            tmp = man_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(man, f, indent=1, default=str)
            os.replace(tmp, man_path)
            # The manifest changed: refresh the sig so the next
            # refresh() keeps this entry instead of rebuilding a
            # tagless one.
            entry["sig"] = _stat_sig(
                man_path, os.path.join(entry.get("dir", ""), _JOURNAL))
        self.stamp(entry)
        return entry

    def load_config(self, entry: dict) -> Optional[dict]:
        """The stored config dict for a run entry (None for sidecar
        sources or pre-registry manifests)."""
        if entry.get("source") != "run":
            return None
        man = _read_json(os.path.join(entry.get("dir", ""), _MANIFEST))
        cfg = (man or {}).get("config")
        return cfg if isinstance(cfg, dict) else None
