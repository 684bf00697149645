"""The campaign scheduler: ordering, budgets, executors, run loop.

The port's copy of the JAX package's ``campaigns/scheduler.py``.  One
campaign is one ordered pass over the expanded cells of a
:class:`CampaignSpec` (spec.py), under the campaign-level exactly-once
journal (journal.py):

- **Ordering** (:func:`order_cells`): priority bands first (higher runs
  first), then grouping inside each band: cells sharing a
  :func:`~.spec.config_signature` run adjacently.  ``--order shuffled``
  (deterministic, keyed on the campaign id) and ``--order spec`` are the
  other orders.

- **Build directory** (``cache_dir``): the port's counterpart of the JAX
  package's persistent compile cache is the kernel-library build
  directory (ops/_build.py ``build_dir``).  With ``cache_dir`` the
  campaign points the libraries' builds there: the inline executor sets
  it for the campaign's duration and restores it afterwards, supervised
  children receive it through :meth:`Campaign.child_env`.
  :func:`trim_cache` keeps the directory under a byte budget between
  cells by evicting the least recently used files.  The libraries are
  keyed by their sources, not by the config, so on a warm directory every
  cell hits and on a cold one only the first cell misses; the counts
  (ops/_build.py ``CACHE_COUNTS`` in process, the 'compile' events of a
  ``--cost-report`` child) are stamped into every cell record and totaled
  in the campaign manifest.  A build or load that fails raises; nothing
  falls back to the plain versions.

- **Deadline** (``deadline_s``): a wall-clock budget per invocation.  The
  scheduler checks it before launching each cell; past the deadline it
  writes a clean 'deadline' manifest and exits :data:`EXIT_DEADLINE` (75,
  EX_TEMPFAIL, resumable), and a re-invoke completes only the remaining
  cells.

Executors: ``inline`` runs cells in-process on the campaign's ``device``
(datasets shared, each cell's engine freed before the next starts);
``supervisor`` runs each cell as a child process under the port's
supervisor (supervisor.py: bounded retries, the degradation ladder, the
per-run journal audit).  Both run cells one at a time: the card holds
one run at a time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import json
import os
import random
import time
from typing import Optional

from attacking_federate_learning_tpu_torch.campaigns.journal import (
    CampaignJournal
)
from attacking_federate_learning_tpu_torch.campaigns.spec import (
    CampaignSpec, cfg_to_cli_args, verify_cli_round_trip
)
from attacking_federate_learning_tpu_torch.utils.metrics import (
    SCHEMA_VERSION, validate_event
)

EXIT_DEADLINE = 75      # EX_TEMPFAIL: checkpointed + resumable, like a
#                         preempted run (utils/lifecycle.py)
_KILL_RC = 137          # the injection seams mimic a SIGKILL


# ---------------------------------------------------------------------------
# ordering

def order_cells(cells, mode: str = "grouped", key: str = "") -> list:
    """Deterministic execution order.  Priority is always the primary
    key (higher first); inside a band, 'grouped' runs config-signature
    groups contiguously (groups in first-appearance order, spec order
    within), 'spec' keeps spec order, 'shuffled' applies a
    deterministic shuffle keyed on ``key``."""
    if mode == "spec":
        return sorted(cells, key=lambda c: (-c.priority, c.index))
    if mode == "grouped":
        first_seen = {}
        for c in sorted(cells, key=lambda c: c.index):
            first_seen.setdefault(c.group, len(first_seen))
        return sorted(cells, key=lambda c: (-c.priority,
                                            first_seen[c.group], c.index))
    if mode == "shuffled":
        seed = int(hashlib.sha1(key.encode()).hexdigest()[:8], 16)
        shuffled = sorted(cells, key=lambda c: c.index)
        random.Random(seed).shuffle(shuffled)
        rank = {c.cell_id: i for i, c in enumerate(shuffled)}
        return sorted(cells, key=lambda c: (-c.priority, rank[c.cell_id]))
    raise ValueError(
        f"order must be 'grouped', 'spec' or 'shuffled', got {mode!r}")


def adjacency(cells) -> int:
    """Number of adjacent same-group pairs in an ordering: the pure
    quantity grouped ordering maximizes."""
    return sum(a.group == b.group for a, b in zip(cells, cells[1:]))


# ---------------------------------------------------------------------------
# build-directory budget

def cache_dir_bytes(path: str) -> int:
    total = 0
    try:
        for name in os.listdir(path):
            try:
                total += os.path.getsize(os.path.join(path, name))
            except OSError:
                pass
    except OSError:
        pass
    return total


def trim_cache(path: str, budget_bytes: int) -> int:
    """Evict least-recently-used files (with their ``-atime`` sidecars,
    where a cache keeps them) until the dir fits the budget; returns the
    entries evicted.  Recency is the newer of the entry's and its
    sidecar's mtime.  Over the kernel-library build directory, an
    evicted library is rebuilt by the next cell that loads it (a
    miss)."""
    if budget_bytes <= 0 or not os.path.isdir(path):
        return 0
    entries = []
    for name in os.listdir(path):
        if name.endswith("-atime"):
            continue
        p = os.path.join(path, name)
        side = os.path.join(path, name + "-atime")
        try:
            size = os.path.getsize(p)
            mtime = os.path.getmtime(p)
        except OSError:
            continue
        try:
            mtime = max(mtime, os.path.getmtime(side))
            size += os.path.getsize(side)
        except OSError:
            side = None
        entries.append((mtime, size, p, side))
    total = sum(e[1] for e in entries)
    evicted = 0
    for mtime, size, p, side in sorted(entries):
        if total <= budget_bytes:
            break
        for victim in (p, side):
            if victim is not None:
                try:
                    os.unlink(victim)
                except OSError:
                    pass
        total -= size
        evicted += 1
    return evicted


def compile_event_cache_counts(events_path: str,
                               offset: int = 0) -> dict:
    """Hit/miss totals from a run's 'compile' events (a ``--cost-report``
    child emits one a kernel library it built or loaded).  ``offset`` skips an
    existing byte prefix: a cell re-run under a second campaign
    APPENDS to the same private log, and the earlier attempts' events
    are not this execution's evidence."""
    hits = misses = 0
    try:
        with open(events_path) as f:
            f.seek(offset)
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if rec.get("kind") == "compile":
                    hits += rec.get("cache") == "hit"
                    misses += rec.get("cache") == "miss"
    except OSError:
        pass
    return {"cache_hits": hits, "cache_misses": misses}


# ---------------------------------------------------------------------------
# executors

class InlineExecutor:
    """Grid-style in-process execution on ``device``: one
    FederatedExperiment per cell, datasets cached across cells, per-cell
    build-directory hit/miss deltas from the process-wide counters
    (ops/_build.py ``CACHE_COUNTS``).  Each cell resolves its kernel
    libraries from the build directory afresh, and its engine is freed
    before the next cell starts.  ``on_start(cell, exp)`` and
    ``on_engine(cell, exp)``, when given, see each engine before it runs
    and each finished engine before it is freed."""

    def __init__(self, device: str = "cuda", on_start=None, on_engine=None):
        self.device = device
        self.on_start = on_start
        self.on_engine = on_engine
        self._datasets = {}

    def _dataset(self, cfg):
        key = (cfg.dataset, cfg.seed, cfg.synth_train, cfg.synth_test,
               cfg.data_dir)
        if key not in self._datasets:
            from attacking_federate_learning_tpu_torch.data.datasets import (
                load_dataset
            )
            self._datasets[key] = load_dataset(
                cfg.dataset, cfg.data_dir, cfg.seed,
                synth_train=cfg.synth_train, synth_test=cfg.synth_test)
        return self._datasets[key]

    def run(self, cell, camp) -> dict:
        try:
            return self._run(cell, camp)
        finally:
            # The engine and its device tensors go before the next cell.
            gc.collect()

    def _run(self, cell, camp) -> dict:
        from attacking_federate_learning_tpu_torch.attacks import (
            make_attacker
        )
        from attacking_federate_learning_tpu_torch.core.engine import (
            FederatedExperiment
        )
        from attacking_federate_learning_tpu_torch.ops import _build
        from attacking_federate_learning_tpu_torch.utils.lifecycle import (
            RunJournal
        )
        from attacking_federate_learning_tpu_torch.utils.metrics import (
            RunLogger
        )

        cfg = cell.cfg
        t0 = time.time()
        try:
            # Backstop for rejections the pre-validation matrix does
            # not know (construction inside the try, like grid.py).
            attacker = make_attacker(
                cfg, dataset=self._dataset(cfg),
                name=None if cell.attack == "auto" else cell.attack,
                device=self.device)
            exp = FederatedExperiment(cfg, attacker=attacker,
                                      dataset=self._dataset(cfg),
                                      device=self.device)
        except ValueError as e:
            return {"state": "skipped", "reason": str(e)}
        if self.on_start is not None:
            self.on_start(cell, exp)
        journal = (RunJournal(cfg.run_dir, cell.cell_id)
                   if camp.journal_runs else None)
        _build.forget_loaded()
        before = dict(_build.CACHE_COUNTS)
        os.makedirs(cfg.log_dir, exist_ok=True)
        try:
            with RunLogger(cfg, cfg.output, cfg.log_dir,
                           jsonl_name=cell.cell_id) as logger:
                out = exp.run(logger, journal=journal)
                events = logger.jsonl_path
        except FloatingPointError as e:     # the backdoor nan guard
            return {"state": "failed", "reason": str(e), "rc": 76,
                    "wall_s": round(time.time() - t0, 2)}
        finally:
            if journal is not None:
                journal.close()
        after = _build.CACHE_COUNTS
        res = {"state": "done", "rc": 0,
               "wall_s": round(time.time() - t0, 2),
               "rounds": cfg.epochs, "events": os.path.abspath(events),
               "cache_hits": after["hit"] - before["hit"],
               "cache_misses": after["miss"] - before["miss"]}
        if out["accuracies"]:
            res["final_accuracy"] = round(float(out["accuracies"][-1]), 4)
            res["max_accuracy"] = round(
                float(max(out["accuracies"])), 4)
        if cfg.backdoor and hasattr(exp.attacker, "test_asr"):
            res["final_asr"] = round(
                float(exp.attacker.test_asr(exp.state.weights)), 4)
        if self.on_engine is not None:
            self.on_engine(cell, exp)
        return res


class SupervisorExecutor:
    """Each cell is a child CLI run (``python -m
    attacking_federate_learning_tpu_torch.cli --device DEVICE``) under the
    port's supervisor (supervisor.py): bounded retries, the degradation
    ladder, pinned ``--run-id`` = the cell id, post-run journal audit.
    ``--cost-report`` is forced onto cells so the library build and load
    attribution lands in the private event log (the campaign's measured
    cache evidence).  A child's kernel launches are counted in the
    child, not in this process.  ``inject_preempt`` maps a cell id to the
    round its child preempts at (the supervisor's
    ``--inject-preempt-round``)."""

    def __init__(self, device: str = "cuda", inject_preempt=None):
        self.device = device
        self.inject_preempt = dict(inject_preempt or {})

    def run(self, cell, camp) -> dict:
        from attacking_federate_learning_tpu_torch import supervisor

        problem = verify_cli_round_trip(cell)
        if problem:
            return {"state": "failed", "reason": problem, "rc": 2}
        child = cfg_to_cli_args(cell.cfg, cell.attack)
        child += ["--device", self.device]
        if camp.cost_report and "--cost-report" not in child:
            child.append("--cost-report")
        opts = supervisor.build_opts(
            run_id=cell.cell_id, verify_journal=True,
            max_retries=camp.max_retries,
            events=os.path.join(camp.dir,
                                f"supervisor_{cell.cell_id}.jsonl"),
            child_env=camp.child_env(),
            inject_preempt_round=self.inject_preempt.get(cell.cell_id))
        # The child's private event log appends across campaigns (same
        # cell id => same file); only events written by THIS execution
        # count as its cache evidence.
        log_path = os.path.join(cell.cfg.log_dir,
                                cell.cell_id + ".jsonl")
        try:
            log_offset = os.path.getsize(log_path)
        except OSError:
            log_offset = 0
        t0 = time.time()
        rc = supervisor.Supervisor(opts, child).supervise()
        res = {"state": "done" if rc == 0 else "failed", "rc": rc,
               "wall_s": round(time.time() - t0, 2)}
        man_path = os.path.join(cell.cfg.run_dir, cell.cell_id,
                                "manifest.json")
        try:
            with open(man_path) as f:
                man = json.load(f)
        except (OSError, json.JSONDecodeError):
            man = {}
        for k in ("final_accuracy", "max_accuracy", "final_asr",
                  "rounds_per_s", "events"):
            if k in man:
                res[k] = man[k]
        if "rounds_committed" in man:
            res["rounds"] = man["rounds_committed"]
        if isinstance(res.get("events"), str):
            res.update(compile_event_cache_counts(res["events"],
                                                  offset=log_offset))
        if rc != 0:
            res.setdefault("reason",
                           f"supervision failed (rc={rc}); see "
                           f"supervisor_{cell.cell_id}.jsonl")
        return res


_EXECUTORS = {"inline": InlineExecutor, "supervisor": SupervisorExecutor}


# ---------------------------------------------------------------------------
# the campaign

class _EphemeralJournal(CampaignJournal):
    """In-memory journal for journal-less sweeps (grid.py's historical
    contract: no runs/ artifacts unless asked).  Same interface, no
    disk, no resume."""

    def records(self):
        return []

    def __init__(self, campaign_id: str):
        self.campaign_id = campaign_id
        self.dir = None
        self.journal_path = self.manifest_path = self.events_path = None
        self._fh = None
        self.cells = {}
        self.attempt = 0
        self.torn_lines = 0

    def _append(self, rec):
        pass

    def write_manifest(self, status, **extra):
        pass

    def read_manifest(self):
        return None


class Campaign:
    """One scheduled pass over a spec's cells.  ``run()`` returns 0
    (all terminal cells done/skipped), 1 (some cell failed), or
    :data:`EXIT_DEADLINE` (stopped cleanly at the wall-clock deadline;
    re-invoke to continue)."""

    def __init__(self, spec: CampaignSpec, run_dir: Optional[str] = None,
                 executor: str = "inline", order: Optional[str] = None,
                 cache_dir: Optional[str] = None,
                 cache_budget_mb: float = 0.0, max_retries: int = 2,
                 deadline_s: Optional[float] = None,
                 journal_runs: bool = True, cost_report: bool = True,
                 persist: bool = True, checks=None, on_cell=None,
                 clock=time.monotonic,
                 kill_after_cells: Optional[int] = None,
                 kill_before_commit: Optional[int] = None,
                 device: str = "cuda"):
        self.spec = spec
        self.device = device
        self.run_dir = run_dir or spec.base.get("run_dir", "runs")
        if isinstance(executor, str):
            if executor not in _EXECUTORS:
                raise ValueError(
                    f"executor must be one of {sorted(_EXECUTORS)}, "
                    f"got {executor!r}")
            self.executor_name = executor
            self.executor = _EXECUTORS[executor](device)
        else:
            # An executor INSTANCE (anything with .run(cell, campaign))
            # — the test seam, and the door to future backends.
            self.executor_name = type(executor).__name__
            self.executor = executor
        self.order = order or spec.order
        self.cache_dir = cache_dir
        self.cache_budget_mb = float(cache_budget_mb)
        self.max_retries = int(max_retries)
        self.deadline_s = (float(deadline_s) if deadline_s is not None
                           else float(spec.deadline_s))
        self.journal_runs = journal_runs
        self.cost_report = cost_report
        self.checks = checks
        self.on_cell = on_cell
        self.clock = clock
        env = os.environ.get
        self.kill_after_cells = (
            kill_after_cells if kill_after_cells is not None
            else int(env("FL_CAMPAIGN_KILL_AFTER_CELLS") or 0) or None)
        self.kill_before_commit = (
            kill_before_commit if kill_before_commit is not None
            else int(env("FL_CAMPAIGN_KILL_BEFORE_COMMIT") or 0) or None)
        self.journal = (CampaignJournal(self.run_dir, spec.campaign_id)
                        if persist
                        else _EphemeralJournal(spec.campaign_id))
        self.dir = self.journal.dir or self.run_dir

    # --- campaign event stream (schema v8 'campaign' kind) ---------------
    def emit(self, phase: str, **fields):
        rec = {"kind": "campaign", "v": SCHEMA_VERSION,
               "campaign": self.spec.campaign_id, "phase": phase,
               "t": round(time.time(), 3), **fields}
        validate_event(rec)
        if self.journal.events_path is not None:
            with open(self.journal.events_path, "a") as f:
                f.write(json.dumps(rec, default=str) + "\n")

    # --- planning ---------------------------------------------------------
    def plan(self) -> list:
        """The ordered cells.  Raises ValueError, before any cell runs,
        when the campaign directory's journal names cells this expansion
        lacks: the JAX package gives one spec the same campaign id and
        directory, and its records must never mix with the port's."""
        cells = order_cells(self.spec.expand(), self.order,
                            self.spec.campaign_id)
        ids = {c.cell_id for c in cells}
        stray = sorted({rec.get("cell") for rec in self.journal.records()
                        if rec.get("kind") == "cell"} - ids)
        if stray:
            raise ValueError(
                f"campaign directory {self.journal.dir} holds a journal "
                f"of cells this expansion lacks ({len(stray)}, e.g. "
                f"{stray[:3]}): the JAX package's campaign of this "
                f"spec; run the port's under another --run-dir")
        return cells

    # --- build-directory environment --------------------------------------
    def child_env(self) -> dict:
        """Env overrides for supervisor-executor children: point the
        kernel libraries' build directory at the campaign's."""
        from attacking_federate_learning_tpu_torch.ops import _build

        if not self.cache_dir:
            return {}
        return {_build.BUILD_DIR_ENV: os.path.abspath(self.cache_dir)}

    @contextlib.contextmanager
    def _inline_cache(self):
        """Point this process's kernel-library builds at the campaign
        dir for the duration (an InlineExecutor, named or given as an
        instance); restores the ambient setting afterwards."""
        if self.cache_dir is None or not isinstance(self.executor,
                                                    InlineExecutor):
            yield
            return
        from attacking_federate_learning_tpu_torch.ops import _build

        os.makedirs(self.cache_dir, exist_ok=True)
        old = _build.set_build_dir(os.path.abspath(self.cache_dir))
        _build.forget_loaded()
        try:
            yield
        finally:
            _build.set_build_dir(old)
            _build.forget_loaded()

    # --- adoption (the zero-duplicate-stamps path) ------------------------
    def _adopt(self, cell) -> Optional[dict]:
        """A cell whose OWN run journal already says 'done' (the kill
        landed between the run finish and the campaign commit) is
        adopted: its metrics are read from the run manifest and the
        cell commits without re-executing — so the engine's registry
        stamp is never duplicated."""
        if not self.journal_runs or cell.cfg is None:
            return None
        man_path = os.path.join(cell.cfg.run_dir, cell.cell_id,
                                "manifest.json")
        try:
            with open(man_path) as f:
                man = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
        if man.get("status") != "done":
            return None
        res = {"rc": 0, "adopted": True,
               "rounds": man.get("rounds_committed")}
        for k in ("final_accuracy", "max_accuracy", "final_asr",
                  "rounds_per_s", "events"):
            if k in man:
                res[k] = man[k]
        if isinstance(res.get("events"), str):
            res.update(compile_event_cache_counts(res["events"]))
        return res

    # --- manifest ---------------------------------------------------------
    def _cell_rows(self, cells) -> dict:
        rows = {}
        for c in cells:
            row = c.row()
            row["state"] = self.journal.state_of(c.cell_id)
            if c.skip:
                row["reason"] = c.skip
            rec = self.journal.cells.get(c.cell_id)
            if rec:
                for k in ("reason", "final_accuracy", "max_accuracy",
                          "final_asr", "rounds", "wall_s",
                          "rounds_per_s", "rc",
                          "cache_hits", "cache_misses", "cache_bytes",
                          "adopted", "events"):
                    if k in rec:
                        row[k] = rec[k]
            rows[c.cell_id] = row
        return rows

    def _cache_totals(self) -> dict:
        hits = misses = 0
        for rec in self.journal.cells.values():
            hits += int(rec.get("cache_hits") or 0)
            misses += int(rec.get("cache_misses") or 0)
        out = {"hits": hits, "misses": misses,
               "budget_mb": self.cache_budget_mb}
        if self.cache_dir:
            out["dir"] = os.path.abspath(self.cache_dir)
            out["bytes"] = cache_dir_bytes(self.cache_dir)
        return out

    def _write_manifest(self, status: str, cells, **extra):
        self.journal.write_manifest(
            status, name=self.spec.name,
            spec_hash=self.spec.spec_hash(), order=self.order,
            executor=self.executor_name, axes=list(self.spec.axes),
            deadline_s=self.deadline_s, cache=self._cache_totals(),
            cells=self._cell_rows(cells), **extra)

    # --- the run loop -----------------------------------------------------
    def _commit(self, cell, state: str, cells, **fields):
        self.journal.commit_cell(cell.cell_id, state, **fields)
        self.emit(f"cell_{state}", cell=cell.cell_id, **{
            k: v for k, v in fields.items()
            if k in ("reason", "rc", "adopted", "cache_hits",
                     "cache_misses", "final_accuracy", "final_asr")})
        self._write_manifest("running", cells)
        if self.on_cell is not None:
            row = self._cell_rows([cell])[cell.cell_id]
            self.on_cell(cell, row)

    def run(self) -> int:
        t0 = self.clock()
        cells = self.plan()
        attempt = self.journal.start_attempt()
        already = sum(not self.journal.fresh(c.cell_id) for c in cells)
        self.emit("campaign_start", attempt=attempt, cells=len(cells),
                  resumed=already, order=self.order,
                  executor=self.executor_name)
        self._write_manifest("running", cells)
        executed = 0
        with self._inline_cache():
            for cell in cells:
                if not self.journal.fresh(cell.cell_id):
                    continue                       # exactly-once gate
                if cell.skip is not None:
                    # Composition-rejected at expansion: never executed.
                    self._commit(cell, "skipped", cells,
                                 reason=cell.skip)
                    continue
                if (self.deadline_s
                        and self.clock() - t0 > self.deadline_s):
                    # The deadline: checkpoint cleanly, leave
                    # the remaining cells pending, exit resumable.
                    self.emit("deadline",
                              elapsed_s=round(self.clock() - t0, 2),
                              remaining=sum(
                                  self.journal.fresh(c.cell_id)
                                  for c in cells))
                    self.journal.finish("deadline")
                    self._write_manifest("deadline", cells)
                    self.journal.close()
                    return EXIT_DEADLINE
                adopted = self._adopt(cell)
                if adopted is not None:
                    self._commit(cell, "done", cells, **adopted)
                    continue
                self.emit("cell_start", cell=cell.cell_id,
                          group=cell.group, priority=cell.priority)
                result = self.executor.run(cell, self)
                executed += 1
                if self.cache_dir and self.cache_budget_mb > 0:
                    trim_cache(self.cache_dir,
                               int(self.cache_budget_mb * 1e6))
                if self.cache_dir:
                    result["cache_bytes"] = cache_dir_bytes(
                        self.cache_dir)
                if (result.get("state") == "done"
                        and self.checks is not None):
                    errors = self.checks(cell, result)
                    if errors:
                        result["state"] = "failed"
                        result["reason"] = "; ".join(errors)
                if self.kill_before_commit == executed:
                    os._exit(_KILL_RC)   # injection: die with the cell
                    #                      finished but uncommitted
                state = result.pop("state")
                self._commit(cell, state, cells, **result)
                if self.kill_after_cells == executed:
                    os._exit(_KILL_RC)   # injection: die between cells
        # Status over the WHOLE journal, not this invocation: a resume
        # that completes the remaining cells still reports a campaign
        # with a previously-failed cell as failed.
        failed = sum(rec.get("state") == "failed"
                     for rec in self.journal.cells.values())
        status = "failed" if failed else "done"
        self.emit("campaign_done", status=status, executed=executed,
                  failed=failed, cache=json.dumps(self._cache_totals()))
        self.journal.finish(status)
        self._write_manifest(status, cells)
        self.journal.close()
        return 1 if failed else 0
