"""The ``runs`` subcommand: query and compare the cross-run registry.

The port's copy of the JAX package's ``runs_cli.py``, over a run store
written by either package (the index and event formats are shared).

``cli.py`` dispatches ``... cli runs <verb>`` here (before argparse, so
the experiment flag surface stays reference-verbatim).  Verbs:

- ``runs list``     — refresh + print the index (``key=value`` filters)
- ``runs show Q``   — one resolved run's full entry + journal audit
- ``runs diff A B`` — field-by-field diff of two runs: config deltas,
  final accuracy/ASR, fault/lifecycle/cache counts, and the per-round
  trajectory divergence point (bit-identity when the shared rounds
  match exactly — the determinism witness two same-seed runs must
  pass).  ``--band N`` relaxes the float comparison to an N-ulp band
  in the float32 domain: cross-ENGINE twins (sharded vs single-device,
  flat vs hierarchical tier-1) legally differ by ~1-ulp reduction
  reorders that cascade through selection-mediated metrics
  (utils/numerics.py:adjudicate's rationale) — exact-float
  compare makes those diffs all-noise, the band names only the real
  divergences
- ``runs compare Q...`` — side-by-side metric table over N runs
- ``runs tag Q TAG``    — attach a resolvable human tag
- ``runs trace Q``      — export the run's event log as Chrome/Perfetto
  trace JSON (utils/trace_export.py; hierarchical runs get the tier-2
  rejection counter + forensics instants as their own track).  This is
  the port's only trace verb: the run resolves through the registry
- ``runs forensics Q``  — tier-2 selection forensics + the colluder-
  localization verdict over a hierarchical run's schema-v6
  shard_selection stream (report.py:forensics_summary)
- ``runs campaign [Q]`` — list campaigns, or render one campaign's
  defense x attack table (report.py:campaign_table) with metric values
  resolved through the registry — the values match the per-run
  manifests bit-exactly, and skipped cells show their composition-
  rejection reason.  Refreshes the registry first (campaign cells
  finish out-of-band, so a cold index would lie)
- ``runs attribution Q [B]`` — per-stage cost table (the stage
  taxonomy: deliver/quarantine/protect/tier1_aggregate/
  tier2_aggregate/apply) and per-seam wire-bytes table from a run's
  schema-v9 ``stage_cost``/``wire_bytes`` events (any --cost-report
  run carries them; campaign cells do automatically), keyed by the
  entry-point names the run wrote (a port run's are its own:
  utils/costs.py, utils/walls.py).  A second query
  renders the two runs' stage/seam diff instead
- ``runs walls Q [B]`` — measured per-stage wall tables from a run's
  schema-v10 ``wall`` events (any --profile-every run carries them):
  per-entry stage-wall medians over the run's trace captures, joined
  to the entry's stage_cost twin for measured-vs-modeled ratios, plus
  the host-clock span/eval rollup.  A second query renders the two
  runs' stage-wall diff instead (delta marks fire above 25% — walls
  are measured, so exact-equality marks would flag noise)
- ``runs margins Q [B]`` — per-defense margin trajectories from a
  run's schema-v12 ``margin`` events (any --margins run carries them):
  the colluder-survival ledger (defense-sign colluder margin,
  selected-colluder count, kept mass) plus the Krum winner/runner-up
  gap and traffic f_eff per round.  A second query renders the two
  runs' colluder-margin drift instead — per-round deltas with
  sign-flip marks (a flip is a defense decision REVERSAL between the
  runs, the signal the margin-drift gate watches)
- ``runs selfcheck``    — CI leg: refresh idempotence + resolvability
  over the current run store

Resolution (utils/registry.py): exact run_id, unique prefix, tag, with
``key=value`` filters narrowing first.  Pure log/JSON reading: no
torch op runs.
Stale-index guard: verbs that read without refreshing warn LOUDLY when
``runs/index.jsonl`` is older than the newest run manifest/journal
(utils/registry.py:stale_run_ids) instead of silently reporting
outdated summaries.
"""

from __future__ import annotations

import argparse
import json
import os

from attacking_federate_learning_tpu_torch.utils.metrics import iter_events
from attacking_federate_learning_tpu_torch.utils.registry import RunRegistry


# Entry fields shown by `runs list` / `runs compare`.
_LIST_FIELDS = ("status", "dataset", "defense", "seed", "rounds_committed",
                "final_accuracy", "final_asr", "tag")
_COMPARE_FIELDS = ("source", "status", "attempts", "rounds_committed",
                   "evals_committed", "final_accuracy", "max_accuracy",
                   "final_asr", "cache_hits", "fault_rounds", "torn_lines")

# Per-round event kinds whose payloads witness the trajectory; 't'
# (wall clock) and 'v' (schema stamp) are not trajectory.
_TRAJ_KINDS = ("round", "eval", "asr", "defense", "attack", "fault",
               "margin", "numerics")
_NON_TRAJ_FIELDS = {"t", "v"}


def _fmt(v):
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.2f}"
    return str(v)


def _load_run_events(entry):
    """The run's event stream (torn-tolerant), or [] when the entry has
    no readable log."""
    path = entry.get("events")
    if not isinstance(path, str) or not os.path.exists(path):
        return []
    return list(iter_events(path, validate=False, skip_bad=True))


def _trajectory(events):
    """{round: {kind: payload}} over the per-round kinds — the
    comparable fingerprint of one run's behavior."""
    out = {}
    for e in events:
        kind = e.get("kind")
        r = e.get("round")
        if kind not in _TRAJ_KINDS or not isinstance(r, (int, float)):
            continue
        payload = {k: v for k, v in e.items()
                   if k not in _NON_TRAJ_FIELDS}
        out.setdefault(int(r), {})[kind] = payload
    return out


def _f32_ord(x: float) -> int:
    """Monotonic integer ordinal of a float in the float32 domain:
    adjacent representable f32 values differ by exactly 1.  Event
    floats are f32 measurements serialized through JSON f64, so the
    f32 lattice is the native resolution of an event-log ulp."""
    import struct

    (u,) = struct.unpack("<I", struct.pack("<f", float(x)))
    return u if u < 0x80000000 else 0x80000000 - u


def _values_match(a, b, band: int) -> bool:
    """Payload-field equality under an optional N-ulp float band.
    ``band == 0`` is exact compare (the same-seed determinism bar);
    ``band > 0`` admits numeric values within ``band`` f32 ulps
    (NaN matches only NaN; lists compare elementwise)."""
    if a == b:
        return True
    if band <= 0:
        return False
    num = (int, float)
    if (isinstance(a, num) and isinstance(b, num)
            and not isinstance(a, bool) and not isinstance(b, bool)):
        if a != a or b != b:            # NaN never passes a == b above:
            return a != a and b != b    # equal only when BOTH are NaN
        try:
            return abs(_f32_ord(a) - _f32_ord(b)) <= band
        except (OverflowError, ValueError):
            return False
    if (isinstance(a, list) and isinstance(b, list)
            and len(a) == len(b)):
        return all(_values_match(x, y, band) for x, y in zip(a, b))
    return False


def diff_trajectories(events_a, events_b, band: int = 0) -> dict:
    """First-divergence analysis over two runs' per-round records.

    Compares the payloads of every shared (round, kind) pair in round
    order; the first mismatch names the round, the kind and the fields
    that differ.  ``bit_identical`` is True when every shared pair
    matches exactly — floats included, which is the right bar: the
    engine is deterministic, so two same-seed runs must reproduce to
    the bit and any ulp wiggle is a real (if legal) program change.
    ``band`` (f32 ulps, ``runs diff --band N``) relaxes the float
    compare for cross-engine twins whose metrics legally sit on 1-ulp
    reduction-reorder flips; a clean banded compare reports
    ``identical_within_band`` instead of bit-identity."""
    ta, tb = _trajectory(events_a), _trajectory(events_b)
    shared = sorted(set(ta) & set(tb))
    out = {"rounds_a": len(ta), "rounds_b": len(tb),
           "rounds_compared": len(shared), "band_ulps": band,
           "divergence_round": None, "bit_identical": False}
    for r in shared:
        kinds = sorted(set(ta[r]) & set(tb[r]))
        for kind in kinds:
            pa, pb = ta[r][kind], tb[r][kind]
            bad = sorted(k for k in set(pa) | set(pb)
                         if not _values_match(pa.get(k), pb.get(k),
                                              band))
            if bad:
                out["divergence_round"] = r
                out["divergence_kind"] = kind
                out["divergence_fields"] = {
                    k: [pa.get(k), pb.get(k)] for k in bad[:5]}
                if kind in ("margin", "numerics"):
                    # The observatory events carry their own stage
                    # attribution: name WHERE in the round pipeline
                    # the first mismatch sits and how big it is in
                    # f32 ulp (utils/numerics.py:FIELD_STAGE).
                    from attacking_federate_learning_tpu_torch.utils import (
                        numerics as N
                    )
                    stage, ulp, anchor = N.divergence_attribution(
                        out["divergence_fields"], kind=kind)
                    out["divergence_stage"] = stage
                    out["divergence_ulp"] = ulp
                    out["divergence_anchor"] = anchor
                return out
    if shared and band == 0:
        out["bit_identical"] = True
    elif shared:
        out["identical_within_band"] = True
    return out


def diff_runs(reg: RunRegistry, ea: dict, eb: dict,
              band: int = 0) -> dict:
    """Field-by-field run diff: config deltas (from the stamped
    manifests), summary-field deltas, and the trajectory divergence
    point from the two event logs (``band``: f32-ulp tolerance for the
    trajectory floats — see :func:`diff_trajectories`)."""
    out = {"a": ea.get("run_id"), "b": eb.get("run_id")}
    ca, cb = reg.load_config(ea), reg.load_config(eb)
    if ca is not None and cb is not None:
        out["config_deltas"] = {
            k: [ca.get(k), cb.get(k)]
            for k in sorted(set(ca) | set(cb)) if ca.get(k) != cb.get(k)}
    out["field_deltas"] = {
        k: [ea.get(k), eb.get(k)]
        for k in _COMPARE_FIELDS if ea.get(k) != eb.get(k)}
    out["trajectory"] = diff_trajectories(_load_run_events(ea),
                                          _load_run_events(eb),
                                          band=band)
    return out


def _print_diff(d, out=print):
    out(f"== runs diff: {d['a']}  vs  {d['b']} ==")
    cd = d.get("config_deltas")
    if cd is None:
        out("  config: no stamped configs (pre-registry manifests)")
    elif not cd:
        out("  config: identical")
    else:
        out(f"  config deltas ({len(cd)}):")
        for k, (va, vb) in cd.items():
            out(f"    {k}: {va!r} -> {vb!r}")
    fd = d["field_deltas"]
    if fd:
        out("  summary deltas:")
        for k, (va, vb) in fd.items():
            out(f"    {k}: {_fmt(va)} vs {_fmt(vb)}")
    else:
        out("  summary: identical")
    tr = d["trajectory"]
    if not tr["rounds_compared"]:
        out("  trajectory: no shared per-round records to compare")
    elif tr["bit_identical"]:
        out(f"  trajectory: BIT-IDENTICAL over {tr['rounds_compared']} "
            f"shared rounds")
    elif tr.get("identical_within_band"):
        out(f"  trajectory: identical within {tr['band_ulps']}-ulp band "
            f"over {tr['rounds_compared']} shared rounds")
    elif tr["divergence_round"] is not None:
        fields = ", ".join(
            f"{k} ({_fmt(v[0])} vs {_fmt(v[1])})"
            for k, v in tr["divergence_fields"].items())
        out(f"  trajectory: first divergence at round "
            f"{tr['divergence_round']} in '{tr['divergence_kind']}' "
            f"[{fields}]")
        if tr.get("divergence_stage") is not None:
            ulp = tr.get("divergence_ulp")
            size = f"{ulp} ulp" if ulp is not None else "non-numeric"
            out(f"    stage: {tr['divergence_stage']} via field "
                f"'{tr['divergence_anchor']}' ({size})")


def _refresh(reg, args):
    summary = reg.refresh(bench=args.bench, progress=args.progress)
    return summary


def _warn_if_stale(reg):
    """The stale-index footgun: reading without refresh must be LOUD
    when the store moved under the index (utils/registry.py)."""
    stale = reg.stale_run_ids()
    if stale:
        show = ", ".join(str(s) for s in stale[:4])
        more = f" (+{len(stale) - 4} more)" if len(stale) > 4 else ""
        print(f"[registry] WARNING: {reg.index_path} is older than "
              f"{len(stale)} run journal(s)/manifest(s): {show}{more} "
              f"— summaries below may be stale; drop --no-refresh or "
              f"run 'runs list' to rebuild")
    return stale


def cmd_list(reg, args):
    if not args.no_refresh:
        s = _refresh(reg, args)
        print(f"[registry] {s['entries']} entries "
              f"({s['built']} rebuilt, {s['reused']} reused"
              + (f", {s['migrated']} checkpoint(s) migrated"
                 if s.get("migrated") else "") + ")")
    else:
        _warn_if_stale(reg)
    ents = reg.entries(args.filter)
    if args.json:
        print(json.dumps(ents, default=str))
        return 0
    if not ents:
        print("no runs in the index (run something with --journal, or "
              "check --run-dir)")
        return 0
    for e in ents:
        cols = "  ".join(f"{k}={_fmt(e.get(k))}" for k in _LIST_FIELDS
                         if e.get(k) is not None)
        print(f"{e['run_id']}  [{e.get('source', '?')}]  {cols}")
    return 0


def cmd_show(reg, args):
    e = reg.resolve(args.query, args.filter)
    if args.json:
        print(json.dumps(e, default=str))
        return 0
    print(f"== {e['run_id']} ==")
    for k in sorted(e):
        if k in ("run_id", "sig"):
            continue
        print(f"  {k}: {e[k]}")
    if e.get("source") == "run":
        from attacking_federate_learning_tpu_torch.utils.lifecycle import (
            RunJournal
        )
        j = RunJournal(os.path.dirname(e["dir"]), e["run_id"])
        problems = j.verify()
        j.close()
        print("  journal audit: " + ("clean" if not problems
                                     else "; ".join(problems)))
    return 0


def cmd_diff(reg, args):
    d = diff_runs(reg, reg.resolve(args.a, args.filter),
                  reg.resolve(args.b, args.filter), band=args.band)
    if args.json:
        print(json.dumps(d, default=str))
    else:
        _print_diff(d)
    return 0


def cmd_compare(reg, args):
    ents = [reg.resolve(q, args.filter) for q in args.queries]
    if args.json:
        print(json.dumps(ents, default=str))
        return 0
    width = max(len(str(e["run_id"])) for e in ents)
    header = f"{'run_id':<{width}}  " + "  ".join(
        f"{k:>14s}" for k in _COMPARE_FIELDS)
    print(header)
    for e in ents:
        print(f"{e['run_id']:<{width}}  " + "  ".join(
            f"{_fmt(e.get(k)):>14s}" for k in _COMPARE_FIELDS))
    return 0


def cmd_tag(reg, args):
    e = reg.tag(args.query, args.tag)
    print(f"tagged {e['run_id']} as {args.tag!r}")
    return 0


def cmd_trace(reg, args):
    from attacking_federate_learning_tpu_torch.utils.trace_export import (
        export_trace
    )

    e = reg.resolve(args.query, args.filter)
    events = e.get("events")
    if not isinstance(events, str) or not os.path.exists(events):
        print(f"run {e['run_id']} has no readable event log "
              f"(events={events!r})")
        return 1
    out = export_trace(events, args.out, name=e["run_id"])
    print(f"wrote {out} (load in chrome://tracing or ui.perfetto.dev)")
    return 0


def cmd_forensics(reg, args):
    """Registry-resolved 'report forensics' (report.py): the tier-2
    rejection attribution + colluder-localization verdict over a
    hierarchical run's schema-v6 shard_selection stream."""
    from attacking_federate_learning_tpu_torch.report import forensics_main

    e = reg.resolve(args.query, args.filter)
    events = e.get("events")
    if not isinstance(events, str) or not os.path.exists(events):
        print(f"run {e['run_id']} has no readable event log "
              f"(events={events!r})")
        return 1
    fargs = [events]
    if args.json:
        fargs.append("--json")
    if args.events:
        fargs += ["--events", args.events]
    return forensics_main(fargs)


def cmd_async(reg, args):
    """Registry-resolved staleness table (report.py:async_summary):
    per-round delivered counts, the aggregate staleness histogram and
    the weight mass per staleness bucket from a run's v7 'async'
    stream.  Exit 1 when the run carries no async events (a
    synchronous run)."""
    import json as _json

    from attacking_federate_learning_tpu_torch.report import (
        async_summary, load_events
    )

    e = reg.resolve(args.query, args.filter)
    events = e.get("events")
    if not isinstance(events, str) or not os.path.exists(events):
        print(f"run {e['run_id']} has no readable event log "
              f"(events={events!r})")
        return 1
    asy = async_summary(load_events([events], skip_bad=True))
    if asy is None:
        print(f"run {e['run_id']}: no 'async' events — the staleness "
              f"table needs an --aggregation async run")
        return 1
    if args.json:
        print(_json.dumps({e["run_id"]: asy}))
        return 0
    print(f"== {e['run_id']} ==")
    print(f"  async rounds {asy['rounds']}: delivered "
          f"{asy['delivered_total']} ({asy['delivered_mean']}/round, "
          f"{asy['empty_rounds']} empty), evicted "
          f"{asy['evicted_total']}, superseded "
          f"{asy['superseded_total']}, quarantined "
          f"{asy['quarantined_total']}")
    print("  delivered per round: "
          + "  ".join(str(d) for d in asy["delivered_per_round"]))
    if "staleness_hist" in asy:
        mass = asy.get("weight_mass",
                       [None] * len(asy["staleness_hist"]))
        print("  staleness   rows   weight mass")
        for s, (h, w) in enumerate(zip(asy["staleness_hist"], mass)):
            wtxt = f"{w:11.3f}" if w is not None else "          -"
            print(f"    s={s}     {h:5d}  {wtxt}")
    return 0


def cmd_traffic(reg, args):
    """Registry-resolved population-traffic table
    (report.py:traffic_summary): per-round arrived counts and
    effective-f, the degradation-ladder action histogram
    (remask/fallback/hold), which defenses actually aggregated, and
    the degraded rounds from a run's v11 'traffic' stream.  Exit 1
    when the run carries no traffic events (a static-cohort run)."""
    import json as _json

    from attacking_federate_learning_tpu_torch.report import (
        load_events, traffic_summary
    )

    e = reg.resolve(args.query, args.filter)
    events = e.get("events")
    if not isinstance(events, str) or not os.path.exists(events):
        print(f"run {e['run_id']} has no readable event log "
              f"(events={events!r})")
        return 1
    tr = traffic_summary(load_events([events], skip_bad=True))
    if tr is None:
        print(f"run {e['run_id']}: no 'traffic' events — the traffic "
              f"table needs a --traffic-population run")
        return 1
    if args.json:
        print(_json.dumps({e["run_id"]: tr}))
        return 0
    print(f"== {e['run_id']} ==")
    print(f"  traffic rounds {tr['rounds']}: arrived "
          f"{tr['arrived_mean']}/round (min {tr['arrived_min']}), "
          f"f_eff {tr['f_eff_mean']}/round (max {tr['f_eff_max']})")
    print("  arrived per round: "
          + "  ".join(str(a) for a in tr["arrived_per_round"]))
    print("  f_eff   per round: "
          + "  ".join(str(f) for f in tr["f_eff_per_round"]))
    print("  action      rounds")
    for a in ("remask", "fallback", "hold"):
        if a in tr["actions"]:
            print(f"    {a:<9} {tr['actions'][a]:5d}")
    for a, n in sorted(tr["actions"].items()):
        if a not in ("remask", "fallback", "hold"):
            print(f"    {a:<9} {n:5d}")
    print("  aggregated by: "
          + ", ".join(f"{d} x{n}"
                      for d, n in sorted(tr["defenses"].items())))
    if tr["degraded_rounds"]:
        print("  degraded rounds: "
              + " ".join(str(r) for r in tr["degraded_rounds"]))
    return 0


def cmd_campaign(reg, args):
    """List campaigns, or render one campaign's defense x attack table
    from the registry (report.py:campaign_table).  The registry is
    refreshed first unless --no-refresh — campaign cells finish in
    child processes, so a cold index would render stale numbers (and
    with --no-refresh the staleness guard warns loudly instead)."""
    from attacking_federate_learning_tpu_torch.report import (
        _print_campaign_table, campaign_table
    )

    camp_root = os.path.join(args.run_dir, "campaigns")
    try:
        names = sorted(
            n for n in os.listdir(camp_root)
            if os.path.exists(os.path.join(camp_root, n,
                                           "manifest.json")))
    except OSError:
        names = []
    if args.query is None:
        if not names:
            print(f"no campaigns under {camp_root} (run one with "
                  f"'campaign spec.json' or 'grid --journal')")
            return 0
        for n in names:
            with open(os.path.join(camp_root, n, "manifest.json")) as f:
                man = json.load(f)
            counts = "  ".join(
                f"{k}={v}" for k, v in sorted(
                    (man.get("counts") or {}).items()))
            print(f"{n}  [{man.get('status', '?')}]  "
                  f"order={man.get('order')}  {counts}")
        return 0
    matches = ([args.query] if args.query in names
               else [n for n in names if n.startswith(args.query)])
    if len(matches) != 1:
        print(f"campaign {args.query!r} "
              + (f"is ambiguous: {matches}" if matches
                 else f"not found under {camp_root} "
                      f"({len(names)} campaigns)"))
        return 2
    with open(os.path.join(camp_root, matches[0],
                           "manifest.json")) as f:
        man = json.load(f)
    if args.no_refresh:
        _warn_if_stale(reg)
    else:
        _refresh(reg, args)
    entries = {str(e.get("run_id")): e for e in reg.entries()}
    table = campaign_table(man, entries)
    if args.json:
        print(json.dumps({"manifest": man, "table": table},
                         default=str))
        return 0
    _print_campaign_table(table)
    counts = man.get("counts") or {}
    print("  cells: " + "  ".join(f"{k}={v}" for k, v in
                                  sorted(counts.items()))
          + f"   cache: {man.get('cache')}")
    return 0


def _attribution_data(events):
    """The run's v9 observability payloads: {entry: stage_cost event}
    (last writer wins — one cost_report per run in practice) plus the
    run's wire_bytes event, or None when the run predates schema v9 /
    ran without --cost-report."""
    stages, wire = {}, None
    for e in events:
        if e.get("kind") == "stage_cost" and isinstance(
                e.get("name"), str):
            stages[e["name"]] = e
        elif e.get("kind") == "wire_bytes":
            wire = e
    if not stages and wire is None:
        return None
    return {"stages": stages, "wire": wire}


def _print_attribution(att):
    from attacking_federate_learning_tpu_torch.utils.costs import STAGES

    for name in sorted(att["stages"]):
        ev = att["stages"][name]
        cov = ev.get("coverage") or {}
        cf, cb = cov.get("flops"), cov.get("bytes_accessed")
        covtxt = ("" if cf is None else
                  f"   coverage: flops {cf:.1%}, bytes {cb:.1%}")
        print(f"  entry {name}{covtxt}")
        print(f"    {'stage':<17}{'MFLOPs':>10}{'MB read+write':>15}"
              f"{'MB temp':>10}")
        rows = dict(ev.get("stages") or {})
        rows["unattributed"] = ev.get("unattributed") or {}
        for stage in tuple(STAGES) + ("unattributed",):
            r = rows.get(stage)
            if r is None:
                continue
            print(f"    {stage:<17}"
                  f"{r.get('flops', 0) / 1e6:>10.2f}"
                  f"{r.get('bytes_accessed', 0) / 1e6:>15.2f}"
                  f"{r.get('temp_bytes', 0) / 1e6:>10.2f}")
    wire = att["wire"]
    if wire:
        print(f"  wire seams ({wire.get('topology')}, cohort "
              f"{wire.get('cohort')}, d={wire.get('dim')}):")
        for seam, rec in (wire.get("seams") or {}).items():
            extra = "  [collective]" if rec.get("collective") else ""
            print(f"    {seam:<22}{rec.get('bytes', 0):>14,} B{extra}")
        print(f"    {'total':<22}{wire.get('total_bytes', 0):>14,} B")


def cmd_attribution(reg, args):
    """Per-stage cost and per-seam wire tables from a run's schema-v9
    ``stage_cost`` / ``wire_bytes`` events (emitted by --cost-report;
    campaign cells carry them automatically).  With a second query,
    diff the two runs' attributions instead — the observability
    counterpart of ``runs diff``'s trajectory compare.  Exit 1 when a
    run carries no attribution events."""
    ents = [reg.resolve(args.query, args.filter)]
    if args.b is not None:
        ents.append(reg.resolve(args.b, args.filter))
    atts = []
    for e in ents:
        att = _attribution_data(_load_run_events(e))
        if att is None:
            print(f"run {e['run_id']}: no stage_cost/wire_bytes "
                  f"events — rerun with --cost-report (schema v9+)")
            return 1
        atts.append(att)
    if args.json:
        print(json.dumps({e["run_id"]: a
                          for e, a in zip(ents, atts)}, default=str))
        return 0
    if len(ents) == 1:
        print(f"== {ents[0]['run_id']} ==")
        _print_attribution(atts[0])
        return 0
    from attacking_federate_learning_tpu_torch.utils.costs import STAGES

    a, b = atts
    ida, idb = ents[0]["run_id"], ents[1]["run_id"]
    print(f"== attribution diff: {ida} vs {idb} ==")
    for name in sorted(set(a["stages"]) | set(b["stages"])):
        ea, eb = a["stages"].get(name), b["stages"].get(name)
        if ea is None or eb is None:
            print(f"  entry {name}: only in "
                  f"{ida if eb is None else idb}")
            continue
        print(f"  entry {name}  (MFLOPs: A, B, delta)")
        ra = dict(ea.get("stages") or {})
        ra["unattributed"] = ea.get("unattributed") or {}
        rb = dict(eb.get("stages") or {})
        rb["unattributed"] = eb.get("unattributed") or {}
        for stage in tuple(STAGES) + ("unattributed",):
            fa = (ra.get(stage) or {}).get("flops", 0.0)
            fb = (rb.get(stage) or {}).get("flops", 0.0)
            if fa == fb == 0:
                continue
            mark = "" if fa == fb else "   <-- differs"
            print(f"    {stage:<17}{fa / 1e6:>10.2f}{fb / 1e6:>10.2f}"
                  f"{(fb - fa) / 1e6:>+10.2f}{mark}")
    wa, wb = a["wire"], b["wire"]
    if wa or wb:
        sa = (wa or {}).get("seams") or {}
        sb = (wb or {}).get("seams") or {}
        print("  wire seams (bytes: A, B, delta)")
        for seam in sorted(set(sa) | set(sb)):
            ba = (sa.get(seam) or {}).get("bytes", 0)
            bb = (sb.get(seam) or {}).get("bytes", 0)
            mark = "" if ba == bb else "   <-- differs"
            print(f"    {seam:<22}{ba:>14,}{bb:>14,}{bb - ba:>+12,}"
                  f"{mark}")
    return 0


def _median(vals):
    vals = sorted(vals)
    return vals[len(vals) // 2] if vals else None


def _walls_data(events):
    """The run's v10 measured-walls payloads, summarized: per-entry
    stage-wall medians over its trace captures (joined to the entry's
    v9 stage_cost for measured-vs-modeled ratios when present), plus
    the host-clock span/eval rollup.  None when the run predates
    schema v10 / ran without --profile-every."""
    from attacking_federate_learning_tpu_torch.utils.costs import STAGES
    from attacking_federate_learning_tpu_torch.utils.walls import (
        measured_vs_modeled
    )

    spans, evals, traces, costs = [], [], {}, {}
    for e in events:
        if e.get("kind") == "wall":
            if e.get("source") == "trace":
                traces.setdefault(str(e.get("name")), []).append(e)
            elif e.get("name") == "eval":
                evals.append(e)
            else:
                spans.append(e)
        elif e.get("kind") == "stage_cost" and isinstance(
                e.get("name"), str):
            costs[e["name"]] = e
    if not spans and not evals and not traces:
        return None
    out = {"host": {}, "entries": {}}
    if spans:
        rps = [e["rounds_per_s"] for e in spans
               if isinstance(e.get("rounds_per_s"), (int, float))]
        out["host"]["spans"] = {
            "count": len(spans),
            "rounds": sum(int(e.get("rounds", 0) or 0) for e in spans),
            "total_wall_s": round(sum(float(e.get("wall_s", 0.0))
                                      for e in spans), 4),
            "median_rounds_per_s": _median(rps)}
    if evals:
        out["host"]["evals"] = {
            "count": len(evals),
            "median_wall_ms": round(1e3 * _median(
                [float(e.get("wall_s", 0.0)) for e in evals]), 3)}
    for name, evs in traces.items():
        agg = {"captures": len(evs),
               "stages": {}, "unattributed_us": _median(
                   [float(e.get("unattributed_us", 0.0))
                    for e in evs])}
        for s in STAGES:
            vals = [float((e.get("stages") or {}).get(s, 0.0))
                    for e in evs]
            if any(v > 0 for v in vals):
                agg["stages"][s] = _median(vals)
        covs = [(e.get("coverage") or {}).get("op_time_fraction")
                for e in evs]
        covs = [c for c in covs if isinstance(c, (int, float))]
        if covs:
            agg["op_time_fraction"] = _median(covs)
        if name in costs:
            agg["vs_modeled"] = measured_vs_modeled(agg, costs[name])
        out["entries"][name] = agg
    return out


def _print_walls(w):
    from attacking_federate_learning_tpu_torch.utils.costs import STAGES

    hs = w["host"].get("spans")
    if hs:
        rps = hs.get("median_rounds_per_s")
        print(f"  host walls: {hs['count']} spans / {hs['rounds']} "
              f"rounds in {hs['total_wall_s']:.2f} s"
              + (f", median {rps:.2f} rounds/s" if rps else ""))
    he = w["host"].get("evals")
    if he:
        print(f"  evals: {he['count']}, median "
              f"{he['median_wall_ms']:.1f} ms")
    for name in sorted(w["entries"]):
        agg = w["entries"][name]
        cov = agg.get("op_time_fraction")
        covtxt = (f"   op-time coverage {cov:.1%}"
                  if cov is not None else "")
        print(f"  entry {name}  ({agg['captures']} capture(s)){covtxt}")
        ratios = agg.get("vs_modeled") or {}
        print(f"    {'stage':<17}{'measured ms':>13}{'share':>8}"
              f"{'modeled':>9}{'ratio':>8}")
        rows = dict(agg.get("stages") or {})
        rows["unattributed"] = agg.get("unattributed_us") or 0.0
        for stage in tuple(STAGES) + ("unattributed",):
            us = rows.get(stage)
            if us is None or (us == 0.0 and stage not in ratios):
                continue
            r = ratios.get(stage) or {}
            share = r.get("measured_share")
            modeled = r.get("modeled_share")
            ratio = r.get("ratio")
            print(f"    {stage:<17}{us / 1e3:>13.3f}"
                  + (f"{share:>8.1%}" if share is not None
                     else f"{'':>8}")
                  + (f"{modeled:>9.1%}" if modeled is not None
                     else f"{'-':>9}")
                  + (f"{ratio:>8.2f}" if ratio is not None
                     else f"{'-':>8}"))


def cmd_walls(reg, args):
    """Measured per-stage wall tables from a run's schema-v10 'wall'
    events (emitted by --profile-every), with measured-vs-modeled
    ratios wherever the run also carries the v9 stage_cost twin.  With
    a second query, diff the two runs' stage walls instead — delta
    marks flag stages whose medians moved by more than 25% (walls are
    measured, so exact-equality marks would fire on noise).  Exit 1
    when a run carries no wall events."""
    ents = [reg.resolve(args.query, args.filter)]
    if args.b is not None:
        ents.append(reg.resolve(args.b, args.filter))
    walls = []
    for e in ents:
        w = _walls_data(_load_run_events(e))
        if w is None:
            print(f"run {e['run_id']}: no wall events — rerun with "
                  f"--profile-every K (schema v10+)")
            return 1
        walls.append(w)
    if args.json:
        print(json.dumps({e["run_id"]: w
                          for e, w in zip(ents, walls)}, default=str))
        return 0
    if len(ents) == 1:
        print(f"== {ents[0]['run_id']} ==")
        _print_walls(walls[0])
        return 0
    from attacking_federate_learning_tpu_torch.utils.costs import STAGES

    a, b = walls
    ida, idb = ents[0]["run_id"], ents[1]["run_id"]
    print(f"== walls diff: {ida} vs {idb} ==")
    ha = (a["host"].get("spans") or {}).get("median_rounds_per_s")
    hb = (b["host"].get("spans") or {}).get("median_rounds_per_s")
    if ha and hb is not None:
        print(f"  rounds/s: {ha:.2f} vs {hb:.2f} "
              f"({(hb - ha) / ha:+.1%})")
    for name in sorted(set(a["entries"]) | set(b["entries"])):
        ea, eb = a["entries"].get(name), b["entries"].get(name)
        if ea is None or eb is None:
            print(f"  entry {name}: only in "
                  f"{ida if eb is None else idb}")
            continue
        print(f"  entry {name}  (measured ms: A, B, delta)")
        ra = dict(ea.get("stages") or {})
        ra["unattributed"] = ea.get("unattributed_us") or 0.0
        rb = dict(eb.get("stages") or {})
        rb["unattributed"] = eb.get("unattributed_us") or 0.0
        for stage in tuple(STAGES) + ("unattributed",):
            ua = float(ra.get(stage, 0.0))
            ub = float(rb.get(stage, 0.0))
            if ua == ub == 0.0:
                continue
            moved = abs(ub - ua) > 0.25 * max(ua, ub)
            mark = "   <-- differs" if moved else ""
            print(f"    {stage:<17}{ua / 1e3:>13.3f}{ub / 1e3:>13.3f}"
                  f"{(ub - ua) / 1e3:>+13.3f}{mark}")
    return 0


def _margin_series_data(events):
    """The run's v12 margin series, or None when the run carries no
    margin events (ran without --margins / predates schema v12)."""
    from attacking_federate_learning_tpu_torch.utils.margins import (
        margin_series
    )

    ser = margin_series(events)
    return ser or None


def cmd_margins(reg, args):
    """Per-defense margin trajectories from a run's schema-v12
    'margin' events (--margins runs; utils/margins.py:margin_series):
    the colluder-survival ledger (defense-sign colluder margin,
    selected-colluder count, kept mass) plus the winner/runner-up gap
    and traffic f_eff per round.  With a second query, render the
    cross-run drift instead — per-round colluder-margin deltas with
    sign-flip marks (a flip is a defense decision reversal, not
    noise).  Exit 1 when a run carries no margin events."""
    ents = [reg.resolve(args.query, args.filter)]
    if args.b is not None:
        ents.append(reg.resolve(args.b, args.filter))
    series = []
    for e in ents:
        s = _margin_series_data(_load_run_events(e))
        if s is None:
            print(f"run {e['run_id']}: no margin events — rerun with "
                  f"--margins (schema v12+)")
            return 1
        series.append(s)
    if args.json:
        print(json.dumps({e["run_id"]: s
                          for e, s in zip(ents, series)}))
        return 0
    from attacking_federate_learning_tpu_torch.utils.margins import (
        SERIES_FIELDS, margin_drift
    )

    def _cell(v):
        if v is None:
            return f"{'-':>10}"
        if isinstance(v, bool) or isinstance(v, int):
            return f"{v:>10d}"
        return f"{float(v):>10.4f}"

    if len(ents) == 1:
        print(f"== {ents[0]['run_id']} ==")
        for d, ser in sorted(series[0].items()):
            fields = [f for f in SERIES_FIELDS
                      if any(v is not None for v in ser[f])]
            print(f"  defense {d} ({len(ser['round'])} rounds)")
            print("    round " + "".join(f"{f:>22}"[-22:] for f in fields))
            for i, r in enumerate(ser["round"]):
                print(f"    {r:>5} " + "".join(
                    f"{'':>12}" + _cell(ser[f][i]) for f in fields))
            cm = [v for v in ser.get("colluder_margin", [])
                  if v is not None]
            if cm:
                neg = sum(1 for v in cm if v <= 0)
                print(f"    colluder margin: min {min(cm):+.4f}, "
                      f"final {cm[-1]:+.4f}, breached (<=0) "
                      f"{neg}/{len(cm)} rounds")
        return 0
    a, b = series
    ida, idb = ents[0]["run_id"], ents[1]["run_id"]
    print(f"== margin drift: {ida} vs {idb} ==")
    for d in sorted(set(a) | set(b)):
        if d not in a or d not in b:
            print(f"  defense {d}: only in {ida if d in a else idb}")
            continue
        dr = margin_drift(a[d], b[d])
        if not dr["rounds"]:
            print(f"  defense {d}: no shared rounds")
            continue
        print(f"  defense {d}  (colluder_margin: A, B, delta)")
        a_by_r = dict(zip(a[d]["round"], a[d]["colluder_margin"]))
        b_by_r = dict(zip(b[d]["round"], b[d]["colluder_margin"]))
        for r, delta in zip(dr["rounds"], dr["delta"]):
            va, vb = a_by_r.get(r), b_by_r.get(r)
            mark = "   <-- sign flip" if r in dr["sign_flips"] else ""
            dtxt = f"{delta:>+13.4f}" if delta is not None else f"{'-':>13}"
            print(f"    round {r:>4}{_cell(va):>13}{_cell(vb):>13}"
                  f"{dtxt}{mark}")
        if dr["sign_flips"]:
            print(f"    sign flips at rounds: "
                  + " ".join(str(r) for r in dr["sign_flips"]))
        else:
            print("    no sign flips (defense decisions stable "
                  "across runs)")
    return 0


def cmd_numerics(reg, args):
    """Numeric-health trajectories from a run's schema-v14 'numerics'
    events (--numerics runs; utils/numerics.py:numerics_series):
    per-round nonfinite counts by stage, gradient-norm dynamic range,
    tie-proximity and cancellation-depth counters, plus the tie-lock
    rollup.  With a second query, report per-field determinism drift
    instead — the first round where the two runs' series differ
    (utils/numerics.py:numerics_drift; same-seed twins must report
    none).  Exit 1 when a run carries no numerics events."""
    from attacking_federate_learning_tpu_torch.utils.numerics import (
        numerics_drift, numerics_series
    )

    ents = [reg.resolve(args.query, args.filter)]
    if args.b is not None:
        ents.append(reg.resolve(args.b, args.filter))
    series = []
    for e in ents:
        s = numerics_series(_load_run_events(e))
        if not s:
            print(f"run {e['run_id']}: no numerics events — rerun "
                  f"with --numerics (schema v14+)")
            return 1
        series.append(s)
    if args.json:
        print(json.dumps({e["run_id"]: {f: list(map(list, v))
                                        for f, v in s.items()}
                          for e, s in zip(ents, series)}))
        return 0

    def _cell(v):
        if isinstance(v, float) and not v.is_integer():
            return f"{v:>12.4f}"
        return f"{int(v):>12d}"

    if len(ents) == 1:
        s = series[0]
        fields = sorted(s)
        rounds = sorted({r for v in s.values() for r, _ in v})
        print(f"== {ents[0]['run_id']} ==")
        print("  round " + "".join(f"{f:>16}"[-16:] for f in fields))
        by_f = {f: dict(s[f]) for f in fields}
        for r in rounds:
            print(f"  {r:>5} " + "".join(
                f"{'':>4}" + (_cell(by_f[f][r]) if r in by_f[f]
                              else f"{'-':>12}") for f in fields))
        nf = [v for _, v in s.get("nonfinite_total", [])]
        locked = [r for r, v in s.get("tie_locked", []) if v]
        ties = [v for _, v in s.get("tie_rows", [])]
        print(f"  health: nonfinite_total sum {int(sum(nf))}, "
              f"tie-locked {len(locked)}/{len(rounds)} rounds"
              + (f" (rounds {' '.join(map(str, locked[:8]))}"
                 + ("..." if len(locked) > 8 else "") + ")"
                 if locked else "")
              + (f", max tie_rows {int(max(ties))}" if ties else ""))
        return 0

    a, b = series
    ida, idb = ents[0]["run_id"], ents[1]["run_id"]
    print(f"== numerics drift: {ida} vs {idb} ==")
    drifted = False
    for f in sorted(set(a) | set(b)):
        if f not in a or f not in b:
            print(f"  {f}: only in {ida if f in a else idb}")
            drifted = True
            continue
        hit = numerics_drift(a, b, field=f)
        if hit is None:
            continue
        r, va, vb = hit
        drifted = True
        print(f"  {f}: first drift at round {r} "
              f"({_fmt(va)} vs {_fmt(vb)})")
    if not drifted:
        shared = len({r for v in a.values() for r, _ in v}
                     & {r for v in b.values() for r, _ in v})
        print(f"  deterministic twins: every shared field agrees over "
              f"{shared} shared rounds")
    return 0


def cmd_selfcheck(reg, args):
    """CI self-check: two refreshes must agree
    (incremental refresh is idempotent over an unchanged store), every
    run entry must resolve by its own id, and the index must survive
    its own round trip."""
    problems = []
    s1 = _refresh(reg, args)
    e1 = reg.entries()
    s2 = _refresh(reg, args)
    e2 = reg.entries()
    if e1 != e2:
        changed = [a.get("run_id") for a, b in zip(e1, e2) if a != b]
        problems.append(f"refresh not idempotent (changed: {changed})")
    if s2["built"] != 0:
        problems.append(f"second refresh rebuilt {s2['built']} "
                        f"entries over an unchanged store")
    for e in e2:
        try:
            got = reg.resolve(str(e["run_id"]))
            if got != e:
                problems.append(f"{e['run_id']}: resolve returned a "
                                f"different entry")
        except ValueError as err:
            problems.append(f"{e['run_id']}: unresolvable: {err}")
    torn = [e["run_id"] for e in e2
            if e.get("problems") or e.get("torn_lines")]
    print(f"[selfcheck] {len(e2)} entries, {s1['built']} rebuilt on "
          f"first refresh, 0 expected on second"
          + (f"; tolerated torn artifacts in {torn}" if torn else ""))
    if problems:
        for p in problems:
            print(f"FAIL selfcheck: {p}")
        return 1
    print("ok   selfcheck: index refresh idempotent, all entries "
          "resolvable")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="attacking_federate_learning_tpu_torch runs",
        description="Query the cross-run registry (utils/registry.py: "
                    "runs/index.jsonl over journal dirs + BENCH/"
                    "PROGRESS artifacts).")
    p.add_argument("--run-dir", default="runs",
                   help="the run store to index (cfg.run_dir)")
    p.add_argument("--bench", action="append", default=None,
                   metavar="GLOB",
                   help="bench JSON glob to ingest on refresh "
                        "(repeatable; default BENCH_*.json; pass '' "
                        "to disable)")
    p.add_argument("--progress", action="append", default=None,
                   metavar="GLOB",
                   help="progress JSONL glob to ingest on refresh "
                        "(repeatable; default PROGRESS.jsonl; pass '' "
                        "to disable)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output")
    p.add_argument("--filter", action="append", default=[],
                   metavar="KEY=VALUE",
                   help="restrict to entries whose field matches "
                        "(repeatable; e.g. --filter defense=Krum)")
    sub = p.add_subparsers(dest="verb", required=True)
    sp = sub.add_parser("list", help="refresh + list the index")
    sp.add_argument("--no-refresh", action="store_true",
                    help="read the existing index without rescanning")
    sp.set_defaults(fn=cmd_list)
    sp = sub.add_parser("show", help="one run's full entry")
    sp.add_argument("query")
    sp.set_defaults(fn=cmd_show)
    sp = sub.add_parser("diff", help="field-by-field diff of two runs")
    sp.add_argument("a")
    sp.add_argument("b")
    sp.add_argument("--band", type=int, default=0, metavar="N",
                    help="f32-ulp tolerance for trajectory floats "
                         "(0 = exact bit compare; N > 0 admits legal "
                         "reduction-reorder wiggle when diffing "
                         "cross-engine twins)")
    sp.set_defaults(fn=cmd_diff)
    sp = sub.add_parser("compare", help="side-by-side metric table")
    sp.add_argument("queries", nargs="+")
    sp.set_defaults(fn=cmd_compare)
    sp = sub.add_parser("tag", help="attach a resolvable tag")
    sp.add_argument("query")
    sp.add_argument("tag")
    sp.set_defaults(fn=cmd_tag)
    sp = sub.add_parser("trace", help="export Chrome/Perfetto trace JSON")
    sp.add_argument("query")
    sp.add_argument("-o", "--out", default=None)
    sp.set_defaults(fn=cmd_trace)
    sp = sub.add_parser("forensics",
                        help="tier-2 selection forensics + colluder "
                             "localization (hierarchical runs with "
                             "--telemetry; report.py)")
    sp.add_argument("query")
    sp.add_argument("--events", default=None, metavar="JSONL",
                    help="append the v6 'forensics' verdict event to "
                         "this run log")
    sp.set_defaults(fn=cmd_forensics)
    sp = sub.add_parser("async",
                        help="staleness table from v7 'async' events "
                             "(--aggregation async runs; report.py "
                             "async_summary)")
    sp.add_argument("query")
    sp.set_defaults(fn=cmd_async)
    sp = sub.add_parser("traffic",
                        help="population-traffic table from v11 "
                             "'traffic' events (--traffic-population "
                             "runs; report.py traffic_summary)")
    sp.add_argument("query")
    sp.set_defaults(fn=cmd_traffic)
    sp = sub.add_parser("campaign",
                        help="list campaigns, or render one campaign's "
                             "defense x attack table from the registry "
                             "(campaigns/, report.py:campaign_table)")
    sp.add_argument("query", nargs="?", default=None,
                    help="campaign id or unique prefix (omit to list)")
    sp.add_argument("--no-refresh", action="store_true",
                    help="skip the registry refresh (the staleness "
                         "guard warns loudly if the store moved)")
    sp.set_defaults(fn=cmd_campaign)
    sp = sub.add_parser("attribution",
                        help="per-stage cost + per-seam wire tables "
                             "from v9 stage_cost/wire_bytes events "
                             "(--cost-report runs); a second query "
                             "diffs two runs")
    sp.add_argument("query")
    sp.add_argument("b", nargs="?", default=None,
                    help="second run: diff B against the first")
    sp.set_defaults(fn=cmd_attribution)
    sp = sub.add_parser("walls",
                        help="measured per-stage wall tables from v10 "
                             "'wall' events (--profile-every runs), "
                             "with measured-vs-modeled ratios; a "
                             "second query diffs two runs")
    sp.add_argument("query")
    sp.add_argument("b", nargs="?", default=None,
                    help="second run: diff B against the first")
    sp.set_defaults(fn=cmd_walls)
    sp = sub.add_parser("margins",
                        help="per-defense margin trajectories from v12 "
                             "'margin' events (--margins runs); a "
                             "second query renders the cross-run "
                             "colluder-margin drift with sign-flip "
                             "marks")
    sp.add_argument("query")
    sp.add_argument("b", nargs="?", default=None,
                    help="second run: drift of B against the first")
    sp.set_defaults(fn=cmd_margins)
    sp = sub.add_parser("numerics",
                        help="numeric-health trajectories from v14 "
                             "'numerics' events (--numerics runs); a "
                             "second query reports per-field "
                             "determinism drift (first differing "
                             "round)")
    sp.add_argument("query")
    sp.add_argument("b", nargs="?", default=None,
                    help="second run: drift of B against the first")
    sp.set_defaults(fn=cmd_numerics)
    sp = sub.add_parser("selfcheck",
                        help="CI: refresh idempotence + resolvability")
    sp.set_defaults(fn=cmd_selfcheck)
    args = p.parse_args(argv)
    if args.bench is None:
        args.bench = ["BENCH_*.json"]
    if args.progress is None:
        args.progress = ["PROGRESS.jsonl"]

    reg = RunRegistry(args.run_dir)
    if args.verb != "list" and not os.path.exists(reg.index_path):
        # Verbs that read the index build it on first use.
        reg.refresh(bench=args.bench, progress=args.progress)
    try:
        return args.fn(reg, args)
    except ValueError as e:
        print(f"runs {args.verb}: {e}")
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
