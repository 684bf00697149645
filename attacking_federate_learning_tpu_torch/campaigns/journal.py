"""Campaign-level exactly-once accounting: journal + atomic manifest.

The port's copy of the JAX package's ``campaigns/journal.py``; the
layout and records are the same, and a spec's campaign id is the same
in both packages, so both would use one ``runs/campaigns/<id>/``.  The
scheduler therefore refuses a directory whose journal names cells its
own expansion lacks (campaigns/scheduler.py ``Campaign.plan``): JAX and
port records never mix.

Same durability contract as the per-run :class:`RunJournal`
(utils/lifecycle.py), one level up: an append-only
``runs/campaigns/<campaign_id>/journal.jsonl`` whose records are
committed *after* the work they describe, plus a ``manifest.json``
rewritten same-dir-tmp + ``os.replace`` at every transition.  A
SIGKILL at any point leaves at most one torn line, which the next
attempt seals and the reader skips; a cell enters the journal at most
once because the scheduler consults :meth:`fresh` before executing and
commits exactly one terminal record per cell.

Cell states: ``done`` (executed to completion, or *adopted* — the
cell's own run journal says 'done', so a kill between the run finish
and the campaign commit re-commits without re-running, which is what
keeps ``runs/index.jsonl`` free of duplicate stamps), ``failed``
(supervision exhausted / the run diverged; terminal — a re-invoke does
not retry it unless asked), ``skipped`` (composition-rejected before
any execution, message attached).  Anything not in the journal is
``pending``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

TERMINAL_STATES = ("done", "failed", "skipped")


class CampaignJournal:
    """Append-only journal + atomic manifest under
    ``<run_dir>/campaigns/<campaign_id>/``."""

    def __init__(self, run_dir: str, campaign_id: str):
        self.campaign_id = campaign_id
        self.dir = os.path.join(run_dir, "campaigns", campaign_id)
        os.makedirs(self.dir, exist_ok=True)
        self.journal_path = os.path.join(self.dir, "journal.jsonl")
        self.manifest_path = os.path.join(self.dir, "manifest.json")
        self.events_path = os.path.join(self.dir, "events.jsonl")
        self._fh = None
        self.cells: dict = {}     # cell_id -> last terminal record
        self.attempt = 0
        self.torn_lines = 0
        self._replay()

    # --- replay ----------------------------------------------------------
    def records(self) -> list:
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
                    torn += 1        # a SIGKILL mid-append leaves one
        self.torn_lines = torn
        return out

    def _replay(self):
        for rec in self.records():
            k = rec.get("kind")
            if k == "cell" and rec.get("state") in TERMINAL_STATES:
                self.cells[rec["cell"]] = rec
            elif k == "attempt":
                self.attempt = max(self.attempt, int(rec["attempt"]))

    # --- append path (torn-tail sealing, flush + fsync) ------------------
    def _append(self, rec: dict):
        if self._fh is None:
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
        self._fh.write(json.dumps(rec, default=str) + "\n")
        self._fh.flush()
        os.fsync(self._fh.fileno())

    # --- transitions ------------------------------------------------------
    def start_attempt(self) -> int:
        self.attempt += 1
        self._append({"kind": "attempt", "attempt": self.attempt})
        return self.attempt

    def fresh(self, cell_id: str) -> bool:
        """True when the cell has no terminal record yet — the gate the
        scheduler consults before executing (exactly-once)."""
        return cell_id not in self.cells

    def state_of(self, cell_id: str) -> str:
        rec = self.cells.get(cell_id)
        return rec["state"] if rec else "pending"

    def commit_cell(self, cell_id: str, state: str, **fields):
        """Commit one terminal record for a cell; recommitting a cell
        is an error (the scheduler must gate on fresh())."""
        if state not in TERMINAL_STATES:
            raise ValueError(
                f"cell state must be one of {TERMINAL_STATES}, "
                f"got {state!r}")
        if not self.fresh(cell_id):
            raise ValueError(
                f"cell {cell_id} already committed as "
                f"{self.state_of(cell_id)!r} (exactly-once violation)")
        rec = {"kind": "cell", "cell": cell_id, "state": state,
               "attempt": self.attempt, **fields}
        self._append(rec)
        self.cells[cell_id] = rec

    def finish(self, status: str, **extra):
        self._append({"kind": "finish", "status": status})
        self.write_manifest(status, **extra)

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # --- manifest ---------------------------------------------------------
    def write_manifest(self, status: str, **extra):
        counts = {}
        for rec in self.cells.values():
            counts[rec["state"]] = counts.get(rec["state"], 0) + 1
        man = {"campaign_id": self.campaign_id, "status": status,
               "attempt": self.attempt,
               "cells_committed": len(self.cells), "counts": counts,
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

    # --- the exactly-once invariant, checked mechanically -----------------
    def verify(self, expected_cells=None) -> list:
        """Audit the raw journal; returns problem strings (empty =
        clean).  Every cell must carry at most one terminal record;
        with ``expected_cells`` (ids), unknown cells are flagged and —
        when the campaign finished — missing ones too."""
        problems = []
        seen: dict = {}
        finished = None
        for rec in self.records():
            k = rec.get("kind")
            if k == "cell":
                cid = rec.get("cell")
                seen[cid] = seen.get(cid, 0) + 1
                if rec.get("state") not in TERMINAL_STATES:
                    problems.append(
                        f"cell {cid}: non-terminal state "
                        f"{rec.get('state')!r} in the journal")
            elif k == "finish":
                finished = rec.get("status")
        dups = sorted(c for c, n in seen.items() if n > 1)
        if dups:
            problems.append(f"cells committed more than once: {dups}")
        if expected_cells is not None:
            expected = set(expected_cells)
            stray = sorted(set(seen) - expected)
            if stray:
                problems.append(f"journal carries unknown cells: {stray}")
            if finished == "done":
                missing = sorted(expected - set(seen))
                if missing:
                    problems.append(
                        f"campaign finished 'done' but cells were "
                        f"never committed: {missing}")
        return problems
