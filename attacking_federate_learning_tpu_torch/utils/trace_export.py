"""Render a run's event log as Chrome/Perfetto trace-event JSON (the
JAX package's utils/trace_export.py, over the port's own
utils/metrics.py:iter_events).

Any run JSONL (every schema version) becomes the Trace Event Format that
``chrome://tracing`` and https://ui.perfetto.dev load:

- **rounds** become complete ("X") spans on one track, each from the
  earliest event naming the round to the next round's;
- **compiles** become "X" spans of their ``compile_s`` on a compile
  track (the kernel libraries' builds, cache in args);
- **evals / asr / lifecycle / faults / stream / registry / gate** become
  instant ("i") events with their payload in args;
- **heartbeats** become counter ("C") tracks (rss_mb, rounds_per_s);
- **shard_selection** rounds (schema v6) become a ``tier2_rejected``
  counter plus instants on a "tier-2 forensics" track naming the
  rejected shards, and a **forensics** verdict an instant on that track;
- **margin** rounds (schema v12) a ``colluder_margin`` counter, and
  **numerics** rounds (schema v14) a ``numerics`` counter;
- the end-of-run **profile** (PhaseTimer) sequential "X" spans on a
  phases track (aggregates, count and mean in args);
- **wall** events (schema v10, ``--profile-every``): each
  source='trace' capture's stage walls sequential "X" spans on a
  "measured stages" track (aggregates over the capture, the relative
  widths utils/walls.py booked), the host-clock walls instants on it.

:func:`device_trace` is utils/profiling.py's capture.  ``validate_trace``
checks an export against the trace-event rules a viewer relies on.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
from typing import Optional

from attacking_federate_learning_tpu_torch.utils.metrics import iter_events


# Track (tid) layout inside the single "run" process.
_TID_ROUNDS = 1
_TID_EVALS = 2
_TID_COMPILES = 3
_TID_LIFECYCLE = 4
_TID_FAULTS = 5
_TID_PHASES = 6
_TID_FORENSICS = 7
_TID_WALLS = 8

_TID_NAMES = {_TID_ROUNDS: "rounds", _TID_EVALS: "evals",
              _TID_COMPILES: "compiles", _TID_LIFECYCLE: "lifecycle",
              _TID_FAULTS: "faults", _TID_PHASES: "phases (aggregate)",
              _TID_FORENSICS: "tier-2 forensics",
              _TID_WALLS: "measured stages (aggregate)"}

_INSTANT_KINDS = {"eval": _TID_EVALS, "asr": _TID_EVALS,
                  "lifecycle": _TID_LIFECYCLE, "fault": _TID_FAULTS,
                  "stream": _TID_LIFECYCLE, "registry": _TID_LIFECYCLE,
                  "gate": _TID_LIFECYCLE, "forensics": _TID_FORENSICS}

# Event-record fields that are bookkeeping, not payload.
_META_FIELDS = {"kind", "t", "v"}


def _us(t_seconds) -> int:
    """Trace-event timestamps are integer microseconds."""
    return int(round(1e6 * float(t_seconds)))


def _args_of(rec) -> dict:
    """JSON-safe payload args: scalars kept, vectors summarized by
    length (a 79k-entry selection mask has no business in a tooltip)."""
    out = {}
    for k, v in rec.items():
        if k in _META_FIELDS:
            continue
        if isinstance(v, (list, tuple)):
            out[k] = f"<{len(v)} values>"
        elif isinstance(v, (dict,)):
            out[k] = f"<{len(v)} fields>"
        else:
            out[k] = v
    return out


def tier2_attribution(event):
    """Per-shard tier-2 selection mass and the rejected-shard set of one
    'shard_selection' event (schema v6), the JAX package's report.py
    rule: a selection kernel (Krum one-hot, Bulyan multi-hot) rejects a
    shard of zero mass; the trimmed mean one kept on fewer than half its
    fair share of coordinates.  ``(None, None)`` when the tier-2 kernel
    exposes no selection (mean, median) or the mask is NaN."""
    mask = event.get("tier2_selection_mask")
    if isinstance(mask, list) and all(x == x for x in mask):
        mass = [float(x) for x in mask]
        return mass, {i for i, x in enumerate(mass) if x <= 0.0}
    kept = event.get("tier2_kept_fraction")
    if isinstance(kept, list) and all(x == x for x in kept):
        mass = [float(x) for x in kept]
        fair = sum(mass) / max(len(mass), 1)
        return mass, {i for i, x in enumerate(mass) if x < 0.5 * fair}
    return None, None


def events_to_trace(events, name: str = "run") -> dict:
    """One run's events (dicts, any schema version) -> a Chrome
    trace-event JSON object ``{"traceEvents": [...]}``."""
    pid = 1
    trace = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
              "args": {"name": name}}]
    for tid, tname in _TID_NAMES.items():
        trace.append({"name": "thread_name", "ph": "M", "pid": pid,
                      "tid": tid, "args": {"name": tname}})

    # Pass 1: per-round open timestamps (earliest event naming the
    # round) and the overall clock extent.
    round_open = {}
    t_max = 0.0
    for e in events:
        t = e.get("t")
        if not isinstance(t, (int, float)):
            continue
        t_max = max(t_max, float(t))
        r = e.get("round")
        if isinstance(r, (int, float)) and e.get("kind") != "heartbeat":
            r = int(r)
            round_open[r] = min(round_open.get(r, float(t)), float(t))

    # Round spans: close each at the next round's open (fused spans
    # surface as a burst of zero-ish-width rounds at the fetch
    # boundary — faithful: that IS when the host learned about them).
    opens = sorted(round_open.items())
    for i, (r, t0) in enumerate(opens):
        t1 = opens[i + 1][1] if i + 1 < len(opens) else max(t_max, t0)
        trace.append({"name": f"round {r}", "ph": "X", "pid": pid,
                      "tid": _TID_ROUNDS, "ts": _us(t0),
                      "dur": max(_us(t1) - _us(t0), 1),
                      "args": {"round": r}})

    for e in events:
        kind = e.get("kind")
        t = e.get("t")
        if kind is None or not isinstance(t, (int, float)):
            continue
        if kind == "compile":
            dur_s = float(e.get("compile_s", 0.0) or 0.0)
            ts = max(float(t) - dur_s, 0.0)   # t stamps the tail
            trace.append({"name": f"compile {e.get('name', '?')}",
                          "ph": "X", "pid": pid, "tid": _TID_COMPILES,
                          "ts": _us(ts), "dur": max(_us(dur_s), 1),
                          "args": _args_of(e)})
        elif kind == "heartbeat":
            for field in ("rss_mb", "rounds_per_s"):
                if isinstance(e.get(field), (int, float)):
                    trace.append({"name": field, "ph": "C", "pid": pid,
                                  "tid": 0, "ts": _us(t),
                                  "args": {field: float(e[field])}})
        elif kind == "profile":
            # Aggregate phase totals laid end to end from t=0: not real
            # intervals (count/mean in args say so), but the relative
            # widths ARE the timing attribution.
            cursor = 0.0
            for pname, row in (e.get("phases") or {}).items():
                total = float(row.get("total_s", 0.0))
                trace.append({"name": pname, "ph": "X", "pid": pid,
                              "tid": _TID_PHASES, "ts": _us(cursor),
                              "dur": max(_us(total), 1),
                              "args": {"count": row.get("count"),
                                       "mean_ms": row.get("mean_ms"),
                                       "aggregate": True}})
                cursor += total
        elif kind == "wall":
            if e.get("source") == "trace":
                # Measured stage walls (schema v10): laid end to end
                # from the event's own timestamp — aggregates over the
                # profiled span, not real intervals (args say so), but
                # the relative widths ARE the measured attribution,
                # the runtime twin of the phases track above.
                cursor = float(t)
                rows = dict(e.get("stages") or {})
                ua = float(e.get("unattributed_us", 0.0) or 0.0)
                if ua > 0:
                    rows["unattributed"] = ua
                for sname, us in rows.items():
                    dur_s = float(us) / 1e6
                    trace.append({"name": f"{e.get('name', '?')}:"
                                          f"{sname}",
                                  "ph": "X", "pid": pid,
                                  "tid": _TID_WALLS, "ts": _us(cursor),
                                  "dur": max(_us(dur_s), 1),
                                  "args": {"measured_us": float(us),
                                           "entry": e.get("name"),
                                           "aggregate": True}})
                    cursor += dur_s
            else:
                # Host-clock span/eval walls: instants on the same
                # track (the payload carries wall_s / rounds_per_s).
                trace.append({"name": f"wall:{e.get('name', '?')}",
                              "ph": "i", "pid": pid, "tid": _TID_WALLS,
                              "ts": _us(t), "s": "t",
                              "args": _args_of(e)})
        elif kind == "shard_selection":
            # Hierarchical forensics (schema v6): the tier-2 rejection
            # attribution as a timeline — a counter of how many shard
            # estimates the cross-shard reduction rejected this round,
            # plus an instant naming the rejected set
            # (:func:`tier2_attribution`; mean/median tier-2 kernels
            # expose no selection and draw no point).
            mass, rejected = tier2_attribution(e)
            if mass is not None:
                trace.append({"name": "tier2_rejected", "ph": "C",
                              "pid": pid, "tid": 0, "ts": _us(t),
                              "args": {"tier2_rejected":
                                       float(len(rejected))}})
                args = _args_of(e)
                args["rejected_shards"] = ",".join(
                    str(s) for s in sorted(rejected)) or "none"
                trace.append({"name": f"tier2 reject "
                                      f"{sorted(rejected)}",
                              "ph": "i", "pid": pid,
                              "tid": _TID_FORENSICS, "ts": _us(t),
                              "s": "t", "args": args})
        elif kind == "margin":
            # Robustness-margin ledger (schema v12, --margins): the
            # defense-sign colluder margin as a counter track next to
            # tier2_rejected — a collapse is the counter crossing zero.
            # Rounds without a finite margin (an async empty delivery
            # makes no decision) draw no point rather than a NaN the
            # viewer can't parse.
            cm = e.get("colluder_margin")
            if isinstance(cm, (int, float)) and math.isfinite(cm):
                trace.append({"name": "colluder_margin", "ph": "C",
                              "pid": pid, "tid": 0, "ts": _us(t),
                              "args": {"colluder_margin": float(cm)}})
        elif kind == "numerics":
            # Numeric-health ledger (schema v14, --numerics): one
            # counter track per round for the health scalars a viewer
            # can eyeball — nonfinite total, tie-proximity count, and
            # cancellation depth.  Hier stacks are lists; only finite
            # scalars draw points (same NaN rule as the margin track).
            vals = {}
            for f in ("nonfinite_total", "tie_rows", "cancel_bits"):
                v = e.get(f)
                if isinstance(v, (int, float)) and math.isfinite(v):
                    vals[f] = float(v)
            if vals:
                trace.append({"name": "numerics", "ph": "C",
                              "pid": pid, "tid": 0, "ts": _us(t),
                              "args": vals})
        elif kind in _INSTANT_KINDS:
            label = kind if kind != "lifecycle" else (
                f"lifecycle:{e.get('phase', '?')}")
            if kind == "forensics":
                label = f"forensics:{e.get('verdict', '?')}"
            trace.append({"name": label, "ph": "i", "pid": pid,
                          "tid": _INSTANT_KINDS[kind], "ts": _us(t),
                          "s": "t", "args": _args_of(e)})
        # round/defense/attack/cost/etc. are covered by the round spans
        # and would only duplicate tooltips.
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


def export_trace(jsonl_path: str, out_path: Optional[str] = None,
                 name: Optional[str] = None, validate: bool = False) -> str:
    """Read one run JSONL (torn tails tolerated — a crashed run's trace
    is exactly the interesting one) and write the trace JSON next to it
    (``<log>.trace.json``) or to ``out_path``.  Returns the path."""
    events = list(iter_events(jsonl_path, validate=validate,
                              skip_bad=True))
    trace = events_to_trace(
        events, name=name or os.path.basename(jsonl_path))
    problems = validate_trace(trace)
    if problems:     # the exporter must never emit an unloadable trace
        raise ValueError(f"exporter bug: {problems[:3]}")
    out_path = out_path or jsonl_path + ".trace.json"
    with open(out_path, "w") as f:
        json.dump(trace, f)
    return out_path


# Phase types this exporter emits; validation is over these (a viewer
# accepts more, but anything else coming out of events_to_trace is a
# bug).
_KNOWN_PH = {"X", "i", "C", "M"}


def validate_trace(obj) -> list:
    """Check a trace object against the Chrome trace-event schema rules
    the viewers rely on; returns a list of problem strings (empty =
    loadable)."""
    problems = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["trace must be a JSON object with a 'traceEvents' list"]
    evs = obj["traceEvents"]
    if not isinstance(evs, list):
        return ["'traceEvents' must be a list"]
    for i, e in enumerate(evs):
        where = f"traceEvents[{i}]"
        if not isinstance(e, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = e.get("ph")
        if ph not in _KNOWN_PH:
            problems.append(f"{where}: unknown ph {ph!r}")
            continue
        if not isinstance(e.get("name"), str) or not e["name"]:
            problems.append(f"{where}: missing/empty name")
        for field in ("pid", "tid"):
            if not isinstance(e.get(field), int):
                problems.append(f"{where}: {field} must be an int")
        if ph != "M":
            ts = e.get("ts")
            if not isinstance(ts, int) or ts < 0:
                problems.append(f"{where}: ts must be a non-negative "
                                f"integer (microseconds), got {ts!r}")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, int) or dur <= 0:
                problems.append(f"{where}: 'X' event needs integer "
                                f"dur > 0, got {dur!r}")
        if ph == "C":
            args = e.get("args")
            if (not isinstance(args, dict) or not args or not all(
                    isinstance(v, (int, float)) for v in args.values())):
                problems.append(f"{where}: 'C' event needs numeric args")
        if ph == "M":
            if not isinstance(e.get("args", {}).get("name"), str):
                problems.append(f"{where}: metadata event needs "
                                f"args.name")
        if ph == "i" and e.get("s") not in (None, "g", "p", "t"):
            problems.append(f"{where}: instant scope must be g/p/t")
    return problems


@contextlib.contextmanager
def device_trace(log_dir: Optional[str], device=None):
    """A profiler capture of the block into ``log_dir``
    (utils/profiling.py:device_trace); a no-op without a directory."""
    from attacking_federate_learning_tpu_torch.utils.profiling import (
        device_trace as _dt
    )
    with _dt(log_dir, device):
        yield
