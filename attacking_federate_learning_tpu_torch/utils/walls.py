"""Measured stage walls: book a ``torch.profiler`` capture onto the stage
taxonomy (the JAX package's utils/walls.py, in PyTorch terms).

A capture (utils/profiling.py:device_trace) is a Chrome-trace JSON with
the stage scopes in it: while a capture is open each
:func:`~.costs.stage_scope` is a ``record_function`` range, a
``user_annotation`` event on the host thread that opened it.  So the
join the JAX package makes through the compiled program's HLO text
happens inside the trace here:

- **On the card** every device event (``kernel``, ``gpu_memcpy``,
  ``gpu_memset``) is booked through its ``correlation`` to the
  ``cuda_runtime`` / ``cuda_driver`` event that launched it, then to the
  innermost stage range open around that launch on the launching
  thread.  A launch from a thread with no stage range open (the autograd
  engine's device thread, which runs ``vmap(grad)``'s backward while the
  round's thread waits in it) takes the innermost range open at that
  moment on the one other thread that has one.  The launch's time
  decides, never the kernel's: on a host-bound round the host closes a
  stage long before its kernels run.
  A device event whose launch is not in the trace is booked by the
  innermost stage among the ``gpu_user_annotation`` ranges the profiler
  projects onto the device timeline, else to ``unattributed``; either
  way it counts in ``unknown_events`` / ``unknown_us``.
- **On a CPU capture** only the outermost ``cpu_op`` events of each
  thread are booked (``aten::linear`` holds ``aten::addmm``: counted
  once), each to the innermost stage range open at its start, on its
  thread or, as above, on the one other thread with a range open.

Every booked event lands in exactly one bucket, so stage sums plus
``unattributed_us`` equal ``total_us`` exactly.  Each booked event is
also filed under its label (:attr:`WallRecord.ops`): the innermost other
``record_function`` range around it (a hand kernel's wrapper names its
C entry point, ``fl_krum_scores``, ...), else the event's own name.
"""

from __future__ import annotations

import bisect
import dataclasses
import glob
import gzip
import json
import os
from collections import defaultdict
from typing import Optional

from attacking_federate_learning_tpu_torch.utils.costs import (
    STAGES, _STAGE_SET
)

_DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
_LAUNCH_CATS = frozenset({"cuda_runtime", "cuda_driver"})


@dataclasses.dataclass
class WallRecord:
    """Measured per-stage time of one capture.

    ``stages`` maps each stage to booked microseconds; ``unattributed_us``
    holds booked time outside every stage range.  ``total_us`` is
    ``sum(stages.values()) + unattributed_us`` — the partition is exact
    by construction, which :meth:`check` re-asserts.  ``coverage``
    reports what the partition does not cover; ``ops`` files the booked
    time by label and stage (``{label: {stage: [events, us]}}``)."""

    name: str
    platform: str = "unknown"
    rounds: Optional[int] = None
    stages: dict = dataclasses.field(default_factory=dict)
    unattributed_us: float = 0.0
    coverage: dict = dataclasses.field(default_factory=dict)
    trace_dir: Optional[str] = None
    ops: dict = dataclasses.field(default_factory=dict)

    @property
    def total_us(self) -> float:
        return sum(self.stages.values()) + self.unattributed_us

    def check(self) -> None:
        """Partition invariant: stage sums + unattributed == total,
        exactly (same floats, same order — not within a tolerance)."""
        total = sum(self.stages.values()) + self.unattributed_us
        if total != self.total_us:
            raise AssertionError(
                f"wall partition broken for {self.name}: "
                f"{total} != {self.total_us}")

    def wall_event(self) -> dict:
        """Schema-v10 'wall' event payload (source='trace')."""
        ev = dict(kind="wall", source="trace", name=self.name,
                  wall_s=round(self.total_us / 1e6, 6),
                  stages={s: round(v, 3)
                          for s, v in self.stages.items()},
                  unattributed_us=round(self.unattributed_us, 3),
                  coverage=self.coverage, platform=self.platform)
        if self.rounds is not None:
            ev["rounds"] = int(self.rounds)
        if self.trace_dir:
            ev["trace_dir"] = self.trace_dir
        return ev


def find_trace_file(trace_dir: str) -> Optional[str]:
    """Newest ``*.trace.json`` (or ``.trace.json.gz``) under a capture's
    directory, or None when the capture wrote nothing."""
    hits = glob.glob(os.path.join(trace_dir, "**", "*.trace.json.gz"),
                     recursive=True)
    hits += glob.glob(os.path.join(trace_dir, "**", "*.trace.json"),
                      recursive=True)
    return max(hits, key=os.path.getmtime) if hits else None


def load_trace_events(path: str) -> list:
    """The X (complete) events of one Chrome-trace JSON (.gz or
    plain)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        obj = json.load(f)
    return [e for e in obj.get("traceEvents", [])
            if isinstance(e, dict) and e.get("ph") == "X"]


class _Ranges:
    """Well-nested ranges of one thread: :meth:`innermost` is the name of
    the innermost range open at a time, or None.  Each range keeps its
    parent (the innermost range holding it), so a lookup walks up from
    the latest range started at or before the time."""

    def __init__(self, ranges):
        ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
        self.starts = [r[0] for r in ranges]
        self.ends = [r[1] for r in ranges]
        self.names = [r[2] for r in ranges]
        self.parent = []
        stack = []
        for i, (s, e, _) in enumerate(ranges):
            while stack and self.ends[stack[-1]] < s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def innermost(self, t: float) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.ends[i] < t:
            i = self.parent[i]
        return self.names[i] if i >= 0 else None


def _ranges_by_thread(events) -> dict:
    by = defaultdict(list)
    for key, s, e, nm in events:
        by[key].append((s, e, nm))
    return {k: _Ranges(v) for k, v in by.items()}


def _innermost(ranges: dict, key, t: float) -> Optional[str]:
    r = ranges.get(key)
    return r.innermost(t) if r is not None else None


def _stage_at(ranges: dict, key, t: float) -> Optional[str]:
    """The innermost stage open at ``t`` on thread ``key``; on a thread
    with none open, the innermost open on the one other thread that has
    one (a worker running for a waiting thread), else None."""
    stage = _innermost(ranges, key, t)
    if stage is not None:
        return stage
    found = {k: r.innermost(t) for k, r in ranges.items() if k != key}
    found = [v for v in found.values() if v is not None]
    return found[0] if len(found) == 1 else None


def book_events(events, name: str = "trace", platform: str = "unknown",
                rounds: Optional[int] = None,
                trace_dir: Optional[str] = None) -> WallRecord:
    """Book a capture's X events onto the stage taxonomy (module
    docstring): the device events where the capture has any, else the
    outermost CPU operations.  Returns the exact partition with its
    coverage: ``op_events`` booked, ``trace_events`` seen, ``booked_us``,
    ``runtime_us`` (the launch calls' host time), ``unknown_events`` /
    ``unknown_us`` (device events booked without their launch) and
    ``op_time_fraction``, the share of booked time joined through a
    launch or a CPU thread's ranges."""
    stage_r, label_r, gstage_r, glabel_r = [], [], [], []
    device, cpu_ops, launches = [], defaultdict(list), {}
    runtime_us = 0.0
    for e in events:
        nm, cat = e.get("name"), e.get("cat")
        if not isinstance(nm, str):
            continue
        ts = float(e.get("ts", 0.0) or 0.0)
        dur = float(e.get("dur", 0.0) or 0.0)
        key = (e.get("pid"), e.get("tid"))
        if cat == "user_annotation":
            (stage_r if nm in _STAGE_SET else label_r).append(
                (key, ts, ts + dur, nm))
        elif cat == "gpu_user_annotation":
            (gstage_r if nm in _STAGE_SET else glabel_r).append(
                (key, ts, ts + dur, nm))
        elif cat in _DEVICE_CATS:
            device.append((key, ts, dur, nm, (e.get("args") or {}).get(
                "correlation")))
        elif cat in _LAUNCH_CATS:
            runtime_us += dur
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (key, ts)
        elif cat == "cpu_op":
            cpu_ops[key].append((ts, dur, nm))
    stage_r, label_r = _ranges_by_thread(stage_r), _ranges_by_thread(label_r)
    gstage_r = _ranges_by_thread(gstage_r)
    glabel_r = _ranges_by_thread(glabel_r)

    booked = []                    # (stage or None, label, us)
    unknown_us, unknown_events = 0.0, 0
    if device:
        for key, ts, dur, nm, corr in device:
            launch = launches.get(corr) if corr is not None else None
            if launch is not None:
                lkey, lts = launch
                stage = _stage_at(stage_r, lkey, lts)
                label = _innermost(label_r, lkey, lts) or nm
            else:
                stage = _innermost(gstage_r, key, ts)
                label = _innermost(glabel_r, key, ts) or nm
                unknown_us += dur
                unknown_events += 1
            booked.append((stage, label, dur))
    else:
        for key, ops in cpu_ops.items():
            ops.sort(key=lambda o: (o[0], -o[1]))
            end = float("-inf")
            for ts, dur, nm in ops:
                if ts < end:
                    continue                 # inside an outer operation
                end = ts + dur
                booked.append((_stage_at(stage_r, key, ts),
                                _innermost(label_r, key, ts) or nm, dur))

    stages = {s: 0.0 for s in STAGES}
    unattributed = 0.0
    by_label: dict = {}
    for stage, label, dur in booked:
        if stage is None:
            unattributed += dur
        else:
            stages[stage] += dur
        cell = by_label.setdefault(label, {}).setdefault(
            stage or "unattributed", [0, 0.0])
        cell[0] += 1
        cell[1] += dur
    total = sum(stages.values()) + unattributed
    rec = WallRecord(
        name=name, platform=platform, rounds=rounds,
        stages={s: v for s, v in stages.items() if v > 0.0},
        unattributed_us=unattributed, trace_dir=trace_dir, ops=by_label)
    rec.coverage = {
        "op_events": len(booked),
        "trace_events": len(events),
        "booked_us": round(total, 3),
        "runtime_us": round(runtime_us, 3),
        "unknown_us": round(unknown_us, 3),
        "unknown_events": unknown_events,
        "op_time_fraction": (round((total - unknown_us) / total, 4)
                             if total > 0 else 0.0),
    }
    rec.check()
    return rec


def book_trace(trace_dir: str, name: str = "trace",
               platform: str = "unknown",
               rounds: Optional[int] = None) -> Optional[WallRecord]:
    """Book the newest capture under ``trace_dir``; None when the
    directory holds no trace."""
    path = find_trace_file(trace_dir)
    if path is None:
        return None
    return book_events(load_trace_events(path), name=name,
                       platform=platform, rounds=rounds,
                       trace_dir=trace_dir)


def measured_vs_modeled(wall_rec: dict, stage_cost: dict) -> dict:
    """Per-stage measured-vs-modeled shares for one entry point: joins
    a 'wall' event (source='trace') with its 'stage_cost' twin by
    stage.  Shares are fractions of each record's own attributed total
    (measured us vs modeled flops), so the ratio is scale-free:
    ratio > 1 means the stage costs more wall time than its modeled
    flop share predicts (memory-bound, host-marshal, launch overhead),
    ratio < 1 the reverse.  Stages absent from either side carry None
    ratios instead of fabricated zeros."""
    meas = dict(wall_rec.get("stages") or {})
    meas["unattributed"] = float(wall_rec.get("unattributed_us", 0.0))
    modeled = {s: float((v or {}).get("flops", 0.0))
               for s, v in (stage_cost.get("stages") or {}).items()}
    modeled["unattributed"] = float(
        (stage_cost.get("unattributed") or {}).get("flops", 0.0))
    mt = sum(meas.values())
    ct = sum(modeled.values())
    out = {}
    for stage in tuple(STAGES) + ("unattributed",):
        m_us = float(meas.get(stage, 0.0))
        flops = modeled.get(stage)
        m_share = (m_us / mt) if mt > 0 else 0.0
        c_share = (flops / ct) if (flops is not None and ct > 0) else None
        row = {"measured_us": round(m_us, 3),
               "measured_share": round(m_share, 4),
               "modeled_share": (round(c_share, 4)
                                 if c_share is not None else None)}
        row["ratio"] = (round(m_share / c_share, 3)
                        if c_share else None)
        if m_us > 0 or (c_share or 0) > 0:
            out[stage] = row
    return out
