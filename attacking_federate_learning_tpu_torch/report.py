"""Run-report tool: read one or more run JSONLs, print forensics.

The port's copy of the JAX package's ``report.py``, reading the shared
event schema (utils/metrics.py) of either package's runs:

- **selection concentration**: distinct winners, top-1 share, malicious
  share, per-client histogram, from 'defense' events' selection masks
  (Krum one-hot, Bulyan multi-hot) or the end-of-run 'selection_hist';
- **phase timing**: the PhaseTimer summary from 'profile' events;
- **trajectories**: accuracy from 'eval' events, attack success from
  'asr' events;
- **staleness rollup**: per-round delivered counts, the staleness
  histogram and the weight mass per staleness bucket from 'async'
  events (core/async_rounds.py);
- **compile & cost**: per entry point, the counted cost beside the
  'compile' events.  A JAX run's 'compile' events are its XLA programs;
  a port run's are the kernel libraries that nvcc built ('miss') or that
  were loaded from the build directory ('hit'), ops/_build.py, and the
  table is headed so.

Usage (cli.py dispatches the subcommand)::

    python -m attacking_federate_learning_tpu_torch.cli report logs/run.jsonl
    python -m attacking_federate_learning_tpu_torch.cli report --json \
        a.jsonl b.jsonl

Several files print side by side plus a concentration comparison table.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import Counter

from attacking_federate_learning_tpu_torch.utils.metrics import iter_events


def load_events(paths, validate: bool = True, skip_bad: bool = False,
                bad_lines: list = None) -> list:
    """All events from the given JSONLs, schema-validated by default.
    ``skip_bad`` tolerates torn/invalid lines (counted into
    ``bad_lines`` as (lineno, msg)) — mixed-version and crash-truncated
    logs summarize instead of aborting the whole invocation."""
    events = []
    for p in paths:
        events.extend(iter_events(p, validate=validate,
                                  skip_bad=skip_bad,
                                  bad_lines=bad_lines))
    return events


def selection_concentration(events):
    """The GRID_RESULTS top-1-share analysis, automated.

    Winners come from 'defense' events' ``selection_mask`` vectors.  A
    run of one-hot masks (Krum) yields a winner histogram with integer
    counts and a malicious-picks total; multi-hot masks (Bulyan) yield
    selection-mass shares.  Returns None when no masks were recorded.
    NaN masks (host engines that never ship the selection back) are
    skipped."""
    masks = []
    for e in events:
        if e.get("kind") == "defense" and "selection_mask" in e:
            m = e["selection_mask"]
            if all(x == x for x in m):      # NaN-free (x != x iff NaN)
                masks.append((m, e.get("malicious_count", 0)))
    if not masks:
        return None
    one_hot = all(abs(sum(m) - 1.0) < 1e-6 for m, _ in masks)
    counts: Counter = Counter()
    mal_mass = total = 0.0
    for m, f in masks:
        for i, x in enumerate(m):
            if x > 0:
                counts[i] += x
                total += x
                if i < f:
                    mal_mass += x
    top1_client, top1 = counts.most_common(1)[0]
    out = {
        "rounds": len(masks),
        "distinct_winners": len(counts),
        "top1_share": round(top1 / total, 4),
        "top1_client": top1_client,
        "malicious_share": round(mal_mass / total, 4),
        "histogram": {str(k): (int(v) if one_hot else round(v, 2))
                      for k, v in sorted(counts.items())},
    }
    if one_hot:
        out["malicious_picks"] = int(round(mal_mass))
    return out


def tier2_attribution(event):
    """Per-shard tier-2 selection mass and the rejected-shard set for
    one 'shard_selection' event (schema v6).

    Selection kernels (Krum one-hot, Bulyan multi-hot) attribute by
    mask: a shard with zero mass was rejected outright.  The trimmed
    mean attributes by kept fraction: a shard kept on fewer than half
    its fair share of coordinates was substantially trimmed out.
    Returns ``(mass, rejected)`` — a length-S float list and a set of
    shard ids — or ``(None, None)`` when the tier-2 kernel exposes no
    selection record (mean, median) or the mask is NaN (host engines).
    Shared with utils/trace_export.py (the tier-2 rejection track)."""
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


def _tier1_concentration(recs):
    """Per-shard tier-1 selection rollup from the stacked (S, m)
    'shard_selection_mask' fields: each shard's top-1 row share and
    the selection mass its own malicious rows (rows [0, mal_counts[s])
    — the placement's malicious-first invariant) captured.  Returns
    None when no tier-1 masks were recorded (NoDefense tier-1, or
    groupwise secagg where per-client rows are invisible)."""
    per_shard: dict = {}
    for e in recs:
        masks = e.get("shard_selection_mask")
        if not isinstance(masks, list) or not masks:
            continue
        if not isinstance(masks[0], list):
            continue
        counts = e.get("mal_counts") or [0] * len(masks)
        for s, row in enumerate(masks):
            if not all(x == x for x in row):
                continue                      # NaN: not measured
            d = per_shard.setdefault(
                s, {"mass": [0.0] * len(row), "total": 0.0,
                    "mal_mass": 0.0, "rounds": 0,
                    "mal_rows": int(counts[s]) if s < len(counts)
                    else 0})
            d["rounds"] += 1
            for i, x in enumerate(row):
                if x > 0:
                    d["mass"][i] += x
                    d["total"] += x
                    if i < d["mal_rows"]:
                        d["mal_mass"] += x
    if not per_shard:
        return None
    out = []
    for s in sorted(per_shard):
        d = per_shard[s]
        top1 = max(d["mass"]) if d["total"] else 0.0
        out.append({
            "shard": s, "mal_rows": d["mal_rows"],
            "rounds": d["rounds"],
            "top1_share": round(top1 / d["total"], 4) if d["total"]
            else None,
            "top1_row": (int(d["mass"].index(top1)) if d["total"]
                         else None),
            "malicious_share": round(d["mal_mass"] / d["total"], 4)
            if d["total"] else None,
        })
    return out


def forensics_summary(events):
    """The forensics layer over a hierarchical run's
    'shard_selection' stream (schema v6):

    - **tier-2 rejection attribution** — which megabatch groups' tier-1
      estimates the cross-shard reduction rejected, round by round;
    - **shard-level selection concentration** — each shard's tier-1
      top-1 share and the mass its own malicious rows captured;
    - **the colluder-localization verdict** — did tier-2 isolate the
      malicious shards (ground truth: the placement's per-shard
      malicious counts, carried by every event), and at what round did
      the localization stabilize (the earliest round from which every
      malicious shard stays rejected through the end of the run).

    Returns None when the run carries no shard_selection events (flat
    runs, telemetry off)."""
    recs = sorted((e for e in events
                   if e.get("kind") == "shard_selection"),
                  key=lambda e: e.get("round", 0))
    if not recs:
        return None
    last = recs[-1]
    mal_counts = last.get("mal_counts")
    mal_shards = ([s for s, c in enumerate(mal_counts) if c > 0]
                  if isinstance(mal_counts, list) else None)
    out = {
        "rounds": len(recs),
        "defense": last.get("defense"),
        "tier2_defense": last.get("tier2_defense"),
        "megabatch": last.get("megabatch"),
        "mal_placement": last.get("mal_placement"),
        "mal_counts": mal_counts,
        "malicious_shards": mal_shards,
    }
    t1 = _tier1_concentration(recs)
    if t1:
        out["tier1"] = t1

    per_round = []                 # (round, mass, rejected)
    for e in recs:
        mass, rejected = tier2_attribution(e)
        if mass is not None:
            per_round.append((int(e.get("round", 0)), mass, rejected))
    if not per_round:
        out["localization"] = {"verdict": "no_attribution"}
        return out
    S = len(per_round[0][1])
    total = [0.0] * S
    rejections = [0] * S
    for _, mass, rejected in per_round:
        for s in range(S):
            total[s] += mass[s]
        for s in rejected:
            rejections[s] += 1
    grand = sum(total) or 1.0
    tier2 = {
        "rounds": len(per_round),
        "selection_share": [round(x / grand, 4) for x in total],
        "rejections": {str(s): rejections[s] for s in range(S)
                       if rejections[s]},
    }
    if mal_shards is not None:
        tier2["malicious_share"] = round(
            sum(total[s] for s in mal_shards) / grand, 4)
        tier2["mal_rejected_rounds"] = sum(
            1 for _, _, rej in per_round
            if all(s in rej for s in mal_shards))
    out["tier2"] = tier2

    if mal_shards is None:
        loc = {"verdict": "no_ground_truth"}
    elif not mal_shards:
        loc = {"verdict": "no_malicious"}
    else:
        # Stabilization: the earliest recorded round from which every
        # malicious shard stays rejected through the end of the run.
        stabilized = None
        for i in range(len(per_round) - 1, -1, -1):
            _, _, rej = per_round[i]
            if all(s in rej for s in mal_shards):
                stabilized = per_round[i][0]
            else:
                break
        if stabilized is not None and all(
                s in per_round[-1][2] for s in mal_shards):
            loc = {"verdict": "localized",
                   "isolated_shards": mal_shards,
                   "stabilized_round": stabilized}
        else:
            loc = {"verdict": "not_localized",
                   "stabilized_round": None}
    out["localization"] = loc
    return out


def fault_recovery(events):
    """Fault/recovery accounting from 'fault' events (core/faults.py +
    the engine watchdog): total injected per kind, quarantined rows,
    rounds touched, and every rollback record.  Returns None when the
    run emitted no fault events (faults off).

    Hierarchical (schema v13) events are shard-qualified — one event
    per ROUND whose scalar counts already sum over shards, with the
    per-shard survivor vector riding along as ``shard_alive`` — so the
    per-round accumulation above needs no change (summing the vector
    AND the scalars would double count; only the scalars are summed).
    The shard-domain axis gets its own rollup: rounds with at least
    one dead domain, total domain deaths, the minimum surviving-shard
    count, and the tier-2 ladder action histogram
    (remask/fallback/hold, core/population.py ACTION_NAMES)."""
    from attacking_federate_learning_tpu_torch.core.population import (
        ACTION_NAMES
    )

    injected = Counter()
    quarantined = rounds = 0
    rollbacks = []
    dead_rounds = shards_dead_total = 0
    min_alive = None
    actions = Counter()
    for e in events:
        if e.get("kind") != "fault":
            continue
        if e.get("rolled_back"):
            rollbacks.append({"round": e["round"],
                              "restored_round": e.get("restored_round"),
                              "rollbacks_total": e.get("rollbacks_total")})
            continue
        rounds += 1
        quarantined += int(e.get("quarantined", 0))
        for k, v in e.items():
            if k.startswith("injected_"):
                injected[k[len("injected_"):]] += int(v)
        if "shards_dead" in e:
            dead = int(e["shards_dead"])
            shards_dead_total += dead
            dead_rounds += dead > 0
            alive = int(e.get("shards_alive", 0))
            min_alive = (alive if min_alive is None
                         else min(min_alive, alive))
        if "tier2_action" in e:
            act = int(e["tier2_action"])
            actions[ACTION_NAMES[act] if 0 <= act < len(ACTION_NAMES)
                    else str(act)] += 1
    if not rounds and not rollbacks:
        return None
    out = {"rounds": rounds, "injected": dict(injected),
           "quarantined": quarantined, "rollbacks": rollbacks}
    if min_alive is not None:
        out["shard_domains"] = {
            "dead_rounds": dead_rounds,
            "shards_dead_total": shards_dead_total,
            "min_shards_alive": min_alive,
            "tier2_actions": dict(actions)}
    return out


def async_summary(events):
    """Staleness rollup from v7 'async' events (core/async_rounds.py):
    per-round delivered counts, the aggregate staleness histogram, the
    weight mass by staleness bucket (how much aggregation influence
    each staleness level actually carried — the staleness-weighting
    policy's measured effect), buffer occupancy, and the
    eviction/supersession/quarantine totals.  Returns None when the
    run emitted no async events (synchronous topologies)."""
    recs = sorted((e for e in events if e.get("kind") == "async"),
                  key=lambda e: e.get("round", 0))
    if not recs:
        return None
    hists = [e.get("staleness_hist") for e in recs
             if isinstance(e.get("staleness_hist"), list)]
    masses = [e.get("weight_mass") for e in recs
              if isinstance(e.get("weight_mass"), list)]
    delivered = [int(e.get("delivered", 0)) for e in recs]
    out = {
        "rounds": len(recs),
        "delivered_per_round": delivered,
        "delivered_total": sum(delivered),
        "delivered_mean": round(sum(delivered) / len(recs), 3),
        "empty_rounds": sum(1 for d in delivered if d == 0),
        "evicted_total": sum(int(e.get("evicted", 0)) for e in recs),
        "superseded_total": sum(int(e.get("superseded", 0))
                                for e in recs),
        "quarantined_total": sum(int(e.get("quarantined", 0))
                                 for e in recs),
        "pending_last": int(recs[-1].get("pending", 0)),
        "in_flight_mean": round(
            sum(int(e.get("in_flight", 0)) for e in recs) / len(recs),
            2),
    }
    if hists:
        depth = max(len(h) for h in hists)
        agg = [0] * depth
        for h in hists:
            for s, v in enumerate(h):
                agg[s] += int(v)
        out["staleness_hist"] = agg
    if masses:
        depth = max(len(w) for w in masses)
        agg_w = [0.0] * depth
        for w in masses:
            for s, v in enumerate(w):
                agg_w[s] += float(v)
        out["weight_mass"] = [round(x, 3) for x in agg_w]
    return out


def traffic_summary(events):
    """Population-traffic rollup from v11 'traffic' events
    (core/population.py): per-round arrived counts and effective-f,
    the degradation-ladder action histogram (remask/fallback/hold),
    which defenses actually aggregated, and the under-fill rounds.
    Returns None when the run emitted no traffic events (a
    static-cohort run)."""
    recs = sorted((e for e in events if e.get("kind") == "traffic"),
                  key=lambda e: e.get("round", 0))
    if not recs:
        return None
    arrived = [int(e.get("arrived", 0)) for e in recs]
    f_eff = [int(e.get("f_eff", 0)) for e in recs]
    actions = {}
    defenses = {}
    for e in recs:
        a = str(e.get("action", "?"))
        actions[a] = actions.get(a, 0) + 1
        d = str(e.get("defense", "?"))
        defenses[d] = defenses.get(d, 0) + 1
    degraded = [int(e.get("round", -1)) for e in recs
                if e.get("action") in ("fallback", "hold")]
    return {
        "rounds": len(recs),
        "arrived_per_round": arrived,
        "arrived_mean": round(sum(arrived) / len(recs), 3),
        "arrived_min": min(arrived),
        "f_eff_per_round": f_eff,
        "f_eff_mean": round(sum(f_eff) / len(recs), 3),
        "f_eff_max": max(f_eff) if f_eff else 0,
        "actions": actions,
        "defenses": defenses,
        "degraded_rounds": degraded,
    }


def secagg_summary(events):
    """Secure-aggregation protocol rollup from 'secagg' events (schema
    v5, protocols/secagg.py): rounds under the protocol, dropout-
    recovery rounds and total masks reconstructed (the simulated
    seed-reveal work), bitwise sum-check failures (must be 0 — the
    mask-cancellation identity is exact), and under groupwise the
    last round's per-group sum norms (the server-visible quantity).
    Returns None when the run emitted no secagg events (secagg off)."""
    recs = [e for e in events if e.get("kind") == "secagg"]
    if not recs:
        return None
    out = {"rounds": len(recs),
           "recovery_rounds": sum(1 for e in recs
                                  if e.get("recovery")),
           "masks_reconstructed": sum(
               int(e.get("masks_reconstructed", 0)) for e in recs),
           "sum_check_failures": sum(
               1 for e in recs if not e.get("sum_check_ok", 1))}
    norms = [e["group_sum_norms"] for e in recs
             if isinstance(e.get("group_sum_norms"), list)]
    if norms:
        out["groups"] = len(norms[-1])
        out["group_sum_norms_last"] = [round(float(x), 3)
                                       for x in norms[-1]]
    return out


# The platform of the port's 'compile' events (utils/costs.py
# CompileLedger.add_compiles): kernel libraries, not XLA programs.
_LIBRARY_PLATFORM = "cuda"


def compile_cost(events):
    """The compile & cost table ('compile'/'cost' events, schema v2 —
    utils/costs.py): per entry point, static FLOPs / bytes-accessed /
    peak-memory facts joined with compile wall time and persistent-
    cache attribution, plus a hit/miss/compile-seconds rollup.  Returns
    None when the run recorded neither kind (cost report off)."""
    compiles = {e["name"]: e for e in events if e.get("kind") == "compile"}
    costs = {e["name"]: e for e in events if e.get("kind") == "cost"}
    if not compiles and not costs:
        return None
    names = list(costs)
    names += [n for n in compiles if n not in costs]
    rows = []
    for name in names:
        c, k = costs.get(name, {}), compiles.get(name, {})
        rows.append({
            "name": name,
            "flops": c.get("flops"),
            "bytes_accessed": c.get("bytes_accessed"),
            "peak_bytes": c.get("peak_bytes"),
            "compile_s": k.get("compile_s"),
            "cache": k.get("cache"),
        })
    cache_tags = [k.get("cache") for k in compiles.values()]
    out = {
        "entries": rows,
        "compile_total_s": round(sum(k.get("compile_s", 0.0)
                                     for k in compiles.values()), 3),
        "cache_hits": sum(1 for t in cache_tags if t == "hit"),
        "cache_misses": sum(1 for t in cache_tags if t == "miss"),
    }
    if compiles and all(k.get("platform") == _LIBRARY_PLATFORM
                        for k in compiles.values()):
        # A port run: its 'compile' events are kernel libraries.
        out["kernel_libraries"] = True
    return out


def lifecycle_summary(events):
    """Run-lifecycle rollup from 'lifecycle' events (schema v3,
    utils/lifecycle.py): per-phase transition counts, the attempt
    count, any degradations applied, and failure classes seen — one
    glance answers "did this run preempt/resume/degrade, and how many
    times did the supervisor have to step in".  Returns None when the
    run recorded no lifecycle events (unsupervised, pre-v3)."""
    lcs = [e for e in events if e.get("kind") == "lifecycle"]
    if not lcs:
        return None
    out = {"transitions": len(lcs),
           "phases": dict(Counter(e["phase"] for e in lcs)),
           "last_phase": lcs[-1]["phase"]}
    attempts = [e["attempt"] for e in lcs
                if isinstance(e.get("attempt"), (int, float))]
    if attempts:
        out["attempts"] = int(max(attempts))
    degradations = [e.get("step") for e in lcs
                    if e["phase"] == "degrade" and e.get("step")]
    if degradations:
        out["degradations"] = degradations
    failures = [e["failure"] for e in lcs if e.get("failure")]
    if failures:
        out["failures"] = dict(Counter(failures))
    return out


def heartbeat_summary(events):
    """Liveness rollup from 'heartbeat' events: count, max last-event
    age (the stall witness) and the final rounds/s EMA."""
    beats = [e for e in events if e.get("kind") == "heartbeat"]
    if not beats:
        return None
    out = {"beats": len(beats),
           "max_event_age_s": max(e["last_event_age_s"] for e in beats),
           "rss_mb_last": beats[-1]["rss_mb"]}
    with_rps = [e for e in beats if "rounds_per_s" in e]
    if with_rps:
        out["rounds_per_s_last"] = with_rps[-1]["rounds_per_s"]
    return out


def numerics_summary(events):
    """Numeric-health rollup from schema-v14 'numerics' events
    (--numerics runs): rounds observed, total nonfinite
    count across every stage counter, rounds with any decision inside
    the tie band (tie-locked — the Bulyan-collapse signature when
    pinned at the round count), the peak tie-proximity count, and the
    peak cancellation depth in bits."""
    from attacking_federate_learning_tpu_torch.utils.numerics import (
        numerics_series
    )

    series = numerics_series(events)
    if not series:
        return None
    rounds = sorted({r for v in series.values() for r, _ in v})
    out = {"rounds": len(rounds),
           "nonfinite_total": int(sum(
               v for _, v in series.get("nonfinite_total", []))),
           "tie_locked_rounds": sum(
               1 for _, v in series.get("tie_locked", []) if v)}
    ties = [v for key, vals in series.items()
            if key.endswith("tie_rows") for _, v in vals]
    if ties:
        out["tie_rows_max"] = int(max(ties))
    bits = [v for key, vals in series.items()
            if key.endswith("cancel_bits") for _, v in vals]
    if bits:
        out["cancel_bits_max"] = round(float(max(bits)), 2)
    return out


def summarize_run(events):
    """One run's report payload from its event list."""
    kinds = Counter(e["kind"] for e in events)
    out = {"events": len(events), "kinds": dict(kinds)}
    for e in events:
        if e["kind"] == "defense":
            out["defense"] = e["defense"]
            break
    for e in events:
        if e["kind"] == "attack":
            out["attack"] = e["attack"]
            break
    evals = [(e["round"], e["accuracy"]) for e in events
             if e["kind"] == "eval"]
    if evals:
        out["accuracy"] = {
            "trajectory": [[r, round(a, 2)] for r, a in evals],
            "final": round(evals[-1][1], 2),
            "max": round(max(a for _, a in evals), 2)}
    asrs = [(e["round"], e["attack_success_rate"]) for e in events
            if e["kind"] == "asr"]
    if asrs:
        out["attack_success"] = {
            "trajectory": [[r, round(a, 2)] for r, a in asrs],
            "final": round(asrs[-1][1], 2)}
    sel = selection_concentration(events)
    if sel:
        out["selection"] = sel
    faults = fault_recovery(events)
    if faults:
        out["faults"] = faults
    sec = secagg_summary(events)
    if sec:
        out["secagg"] = sec
    asy = async_summary(events)
    if asy:
        out["async"] = asy
    fx = forensics_summary(events)
    if fx:
        out["forensics"] = fx
    hists = [e for e in events if e["kind"] == "selection_hist"]
    if hists:
        out["selection_hist"] = {
            k: hists[-1][k] for k in ("counts", "rounds", "distinct_winners",
                                      "top1_share", "top1_client",
                                      "malicious_picks")
            if k in hists[-1]}
    cc = compile_cost(events)
    if cc:
        out["compile_cost"] = cc
    lc = lifecycle_summary(events)
    if lc:
        out["lifecycle"] = lc
    hb = heartbeat_summary(events)
    if hb:
        out["heartbeat"] = hb
    nm = numerics_summary(events)
    if nm:
        out["numerics"] = nm
    profiles = [e for e in events if e["kind"] == "profile"]
    if profiles:
        out["phases"] = profiles[-1]["phases"]
    streams = [e for e in events if e["kind"] == "stream"]
    if streams:
        out["stream"] = {k: v for k, v in streams[-1].items()
                         if k.startswith("stream_")}
    return out


def _print_run(path, s, out):
    out(f"== {path} ==")
    head = [f"{s['events']} events"]
    if s.get("bad_lines"):
        head.append(f"{s['bad_lines']} torn/invalid line(s) skipped")
    if "defense" in s:
        head.append(f"defense={s['defense']}")
    if "attack" in s:
        head.append(f"attack={s['attack']}")
    out("  " + "  ".join(head))
    if "accuracy" in s:
        traj = " -> ".join(f"[{r}] {a:.2f}%"
                           for r, a in s["accuracy"]["trajectory"])
        out(f"  accuracy: {traj}  (max {s['accuracy']['max']:.2f}%)")
    if "attack_success" in s:
        traj = " -> ".join(f"[{r}] {a:.2f}%"
                           for r, a in s["attack_success"]["trajectory"])
        out(f"  attack success: {traj}")
    sel = s.get("selection")
    if sel:
        out(f"  selection concentration over {sel['rounds']} rounds:")
        out(f"    distinct winners {sel['distinct_winners']}, "
            f"top-1 share {sel['top1_share']:.3f} "
            f"(client {sel['top1_client']}), "
            f"malicious share {sel['malicious_share']:.3f}"
            + (f", malicious picks {sel['malicious_picks']}"
               if "malicious_picks" in sel else ""))
        hist = "  ".join(f"{k}:{v}" for k, v in sel["histogram"].items())
        out(f"    histogram  {hist}")
    flt = s.get("faults")
    if flt:
        inj = "  ".join(f"{k}:{v}" for k, v in sorted(
            flt["injected"].items())) or "none"
        out(f"  faults over {flt['rounds']} rounds: injected [{inj}]  "
            f"quarantined {flt['quarantined']}")
        sd = flt.get("shard_domains")
        if sd:
            acts = "  ".join(f"{k}:{v}" for k, v in sorted(
                sd["tier2_actions"].items())) or "none"
            out(f"    shard domains: {sd['dead_rounds']} round(s) with "
                f"a dead domain ({sd['shards_dead_total']} shard-round "
                f"deaths), min shards alive "
                f"{sd['min_shards_alive']}  tier-2 ladder [{acts}]")
        for rb in flt["rollbacks"]:
            out(f"    rollback at round {rb['round']} -> restored round "
                f"{rb['restored_round']} (total {rb['rollbacks_total']})")
    sec = s.get("secagg")
    if sec:
        line = (f"  secagg: {sec['rounds']} masked rounds, "
                f"{sec['recovery_rounds']} recovery round(s), "
                f"{sec['masks_reconstructed']} masks reconstructed, "
                f"{sec['sum_check_failures']} sum-check failure(s)")
        if "groups" in sec:
            line += f", {sec['groups']} groups"
        out(line)
        if "group_sum_norms_last" in sec:
            out("    group sum norms (last round): "
                + "  ".join(f"{x:.3f}"
                            for x in sec["group_sum_norms_last"]))
    asy = s.get("async")
    if asy:
        out(f"  async rounds: {asy['rounds']}  delivered "
            f"{asy['delivered_total']} total "
            f"({asy['delivered_mean']}/round, {asy['empty_rounds']} "
            f"empty)  evicted {asy['evicted_total']}  superseded "
            f"{asy['superseded_total']}  quarantined "
            f"{asy['quarantined_total']}  in-flight mean "
            f"{asy['in_flight_mean']}  pending at end "
            f"{asy['pending_last']}")
        traj = "  ".join(str(d) for d in asy["delivered_per_round"])
        out(f"    delivered per round: {traj}")
        if "staleness_hist" in asy:
            hist = asy["staleness_hist"]
            mass = asy.get("weight_mass", [None] * len(hist))
            out("    staleness   rows   weight mass")
            for sname, (h, w) in enumerate(zip(hist, mass)):
                wtxt = f"{w:11.3f}" if w is not None else "          -"
                out(f"      s={sname}     {h:5d}  {wtxt}")
    fx = s.get("forensics")
    if fx:
        _print_forensics(fx, out, indent="  ")
    cc = s.get("compile_cost")
    if cc:
        if cc.get("kernel_libraries"):
            out(f"  kernel libraries & cost ({cc['compile_total_s']:.2f} "
                f"s total nvcc build; build directory "
                f"{cc['cache_hits']} hit / {cc['cache_misses']} miss):")
        else:
            out(f"  compile & cost ({cc['compile_total_s']:.2f} s total "
                f"compile; cache {cc['cache_hits']} hit / "
                f"{cc['cache_misses']} miss):")
        for r in cc["entries"]:
            flops = (f"{r['flops']:.3e}" if r.get("flops") is not None
                     else "-")
            byts = (f"{r['bytes_accessed']:.3e}"
                    if r.get("bytes_accessed") is not None else "-")
            peak = (f"{r['peak_bytes'] / 1e6:8.1f} MB"
                    if r.get("peak_bytes") is not None else "        -")
            comp = (f"{r['compile_s']:6.2f} s"
                    if r.get("compile_s") is not None else "     -")
            out(f"    {r['name']:16s} flops {flops:>10s}   "
                f"bytes {byts:>10s}   peak {peak}   "
                f"compile {comp} ({r.get('cache', '-')})")
    lc = s.get("lifecycle")
    if lc:
        phases = "  ".join(f"{k}:{v}" for k, v in sorted(
            lc["phases"].items()))
        line = (f"  lifecycle: {phases}  (last {lc['last_phase']}")
        if "attempts" in lc:
            line += f", {lc['attempts']} attempt(s)"
        line += ")"
        out(line)
        if "degradations" in lc:
            out(f"    degradations: {', '.join(lc['degradations'])}")
        if "failures" in lc:
            fl = "  ".join(f"{k}:{v}" for k, v in sorted(
                lc["failures"].items()))
            out(f"    failures seen: {fl}")
    hb = s.get("heartbeat")
    if hb:
        line = (f"  heartbeat: {hb['beats']} beats, max event age "
                f"{hb['max_event_age_s']:.1f} s, rss "
                f"{hb['rss_mb_last']:.0f} MB")
        if "rounds_per_s_last" in hb:
            line += f", {hb['rounds_per_s_last']:.2f} rounds/s"
        out(line)
    nm = s.get("numerics")
    if nm:
        line = (f"  numerics: {nm['rounds']} rounds observed, "
                f"nonfinite total {nm['nonfinite_total']}, "
                f"tie-locked {nm['tie_locked_rounds']}/{nm['rounds']} "
                f"rounds")
        if "tie_rows_max" in nm:
            line += f", max tie rows {nm['tie_rows_max']}"
        if "cancel_bits_max" in nm:
            line += f", max cancellation {nm['cancel_bits_max']} bits"
        out(line)
    if "phases" in s:
        out("  phase timing:")
        for name, row in s["phases"].items():
            out(f"    {name:10s} total {row['total_s']:9.3f} s   "
                f"count {row['count']:5d}   mean {row['mean_ms']:8.3f} ms")
    if "stream" in s:
        out("  stream: " + "  ".join(f"{k}={v}"
                                     for k, v in s["stream"].items()))


def campaign_table(manifest, registry_entries=None) -> dict:
    """Defense x attack table for one campaign manifest
    (campaigns/journal.py), with metric values taken from the CROSS-RUN
    REGISTRY (utils/registry.py) — the per-run manifests are the source
    of truth and the registry copies them verbatim, so the rendered
    numbers match the run manifests bit-exactly.  Skipped cells carry
    their composition-rejection reason; a done cell with no registry
    entry (an unjournaled sweep) falls back to the campaign manifest's
    own copy, flagged in ``problems``.

    Returns {rows, cols, cells, problems}: ``cells`` maps
    ``"defense|attack"`` to the list of cell records in that bucket
    (one per cell — seed/epochs axes stack multiple records per
    bucket)."""
    rows, cols, cells, problems = [], [], {}, []
    for cid, row in (manifest.get("cells") or {}).items():
        d = str(row.get("defense", "?"))
        a = str(row.get("attack", "auto"))
        if d not in rows:
            rows.append(d)
        if a not in cols:
            cols.append(a)
        rec = {"cell": cid, "state": row.get("state")}
        if row.get("state") == "done":
            src = None
            if registry_entries is not None:
                src = registry_entries.get(cid)
            if src is not None:
                rec["source"] = "registry"
            else:
                src, rec["source"] = row, "manifest"
                if registry_entries is not None:
                    problems.append(
                        f"{cid}: no registry entry (unjournaled "
                        f"cell?); values from the campaign manifest")
            for k in ("final_accuracy", "max_accuracy", "final_asr",
                      "rounds_per_s", "wall_s"):
                if src.get(k) is not None:
                    rec[k] = src[k]
            # A registry-sourced cell may still carry its wall_s only
            # in the campaign manifest (the scheduler timed the cell;
            # the engine stamped rounds_per_s) — take either headline
            # wherever it lives, so the time column survives both
            # sources.
            for k in ("rounds_per_s", "wall_s"):
                if rec.get(k) is None and row.get(k) is not None:
                    rec[k] = row[k]
        else:
            rec["reason"] = row.get("reason")
        cells.setdefault(f"{d}|{a}", []).append(rec)
    return {"campaign_id": manifest.get("campaign_id"),
            "status": manifest.get("status"), "rows": rows,
            "cols": cols, "cells": cells, "problems": problems}


def _campaign_cell_text(recs) -> str:
    parts = []
    for rec in recs:
        if rec["state"] == "done":
            txt = (f"{rec['final_accuracy']:.2f}"
                   if rec.get("final_accuracy") is not None else "done")
            if rec.get("final_asr") is not None:
                txt += f"/asr {rec['final_asr']:.2f}"
        elif rec["state"] == "skipped":
            txt = "skip"
        elif rec["state"] == "pending":
            txt = "pending"
        else:
            txt = rec["state"].upper()
        parts.append(txt)
    return " ; ".join(parts) if parts else "-"


def _row_time_text(table, d) -> str:
    """The time-column cell for one defense row: the median engine
    rounds/s over the row's done cells (schema-v10 measured-walls
    headline the engine stamps into the registry), falling back to the
    scheduler's cell wall when no engine headline exists."""
    rps = [rec["rounds_per_s"] for a in table["cols"]
           for rec in table["cells"].get(f"{d}|{a}", [])
           if rec.get("rounds_per_s") is not None]
    if rps:
        rps.sort()
        return f"{rps[len(rps) // 2]:.2f} r/s"
    walls = [rec["wall_s"] for a in table["cols"]
             for rec in table["cells"].get(f"{d}|{a}", [])
             if rec.get("wall_s") is not None]
    if walls:
        walls.sort()
        return f"{walls[len(walls) // 2]:.0f} s"
    return "-"


def _print_campaign_table(table, out=print):
    out(f"== campaign {table['campaign_id']}  "
        f"[{table['status']}] ==")
    width = max([len(r) for r in table["rows"]] + [7])
    cw = {a: max(len(a), 12) for a in table["cols"]}
    has_time = any(rec.get("rounds_per_s") is not None
                   or rec.get("wall_s") is not None
                   for recs in table["cells"].values() for rec in recs)
    header = ("  " + " " * width + "  "
              + "  ".join(f"{a:>{cw[a]}s}" for a in table["cols"]))
    if has_time:
        header += f"  {'time':>10s}"
    out(header)
    for d in table["rows"]:
        line = f"  {d:<{width}s}  "
        line += "  ".join(
            _campaign_cell_text(table["cells"].get(f"{d}|{a}", [])).rjust(
                cw[a]) for a in table["cols"])
        if has_time:
            line += f"  {_row_time_text(table, d):>10s}"
        out(line)
    skips = [(key, rec) for key, recs in table["cells"].items()
             for rec in recs if rec["state"] == "skipped"]
    if skips:
        out("  skipped cells:")
        for key, rec in skips:
            out(f"    {key}: {rec.get('reason')}")
    fails = [(key, rec) for key, recs in table["cells"].items()
             for rec in recs if rec["state"] == "failed"]
    if fails:
        out("  failed cells:")
        for key, rec in fails:
            out(f"    {key}: {rec.get('reason')}")
    for prob in table["problems"]:
        out(f"  WARNING: {prob}")


def _print_forensics(fx, out, indent="  "):
    """Human-readable forensics table (shared by the per-run summary
    and the 'report forensics' subcommand)."""
    out(f"{indent}hierarchical forensics over {fx['rounds']} rounds: "
        f"{fx.get('defense')} tier-1 / {fx.get('tier2_defense')} "
        f"tier-2, megabatch {fx.get('megabatch')}, placement "
        f"{fx.get('mal_placement')}")
    if fx.get("mal_counts") is not None:
        out(f"{indent}  malicious shards (ground truth): "
            f"{fx.get('malicious_shards')}  (per-shard counts "
            f"{fx['mal_counts']})")
    t2 = fx.get("tier2")
    if t2:
        share = "  ".join(f"{s}:{x:.3f}"
                          for s, x in enumerate(t2["selection_share"]))
        out(f"{indent}  tier-2 selection share by shard: {share}")
        rej = "  ".join(f"{s}:{c}" for s, c in
                        sorted(t2["rejections"].items(),
                               key=lambda kv: int(kv[0]))) or "none"
        out(f"{indent}  tier-2 rejections (rounds rejected): {rej}")
        if "malicious_share" in t2:
            out(f"{indent}  malicious selection share "
                f"{t2['malicious_share']:.3f}; all-malicious-rejected "
                f"rounds {t2['mal_rejected_rounds']}/{t2['rounds']}")
    loc = fx.get("localization", {})
    verdict = loc.get("verdict")
    if verdict == "localized":
        out(f"{indent}  localization: LOCALIZED from round "
            f"{loc['stabilized_round']} — tier-2 isolated shard(s) "
            f"{loc['isolated_shards']}")
    else:
        out(f"{indent}  localization: {verdict}")
    for row in fx.get("tier1", []):
        out(f"{indent}  tier-1 shard {row['shard']} "
            f"({row['mal_rows']} malicious rows): top-1 share "
            f"{row['top1_share']} (row {row['top1_row']}), malicious "
            f"share {row['malicious_share']}")


def forensics_main(argv=None) -> int:
    """``report forensics`` — the tier-2 selection forensics +
    colluder-localization verdict over hierarchical runs'
    'shard_selection' streams (schema v6).  Exit 0 when every given
    log yields a verdict, 1 when any log carries no shard_selection
    events (a flat run, or telemetry off — named per file)."""
    p = argparse.ArgumentParser(
        prog="attacking_federate_learning_tpu_torch report forensics",
        description="Tier-2 selection forensics and colluder "
                    "localization from 'shard_selection' events "
                    "(hierarchical + groupwise-secagg runs with "
                    "--telemetry).")
    p.add_argument("paths", nargs="*", metavar="RUN_JSONL")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output (one object keyed by "
                        "path)")
    p.add_argument("--skip-bad", action="store_true",
                   help="tolerate torn/invalid lines")
    p.add_argument("--events", default=None, metavar="JSONL",
                   help="append one v6 'forensics' verdict event per "
                        "analyzed log to this run log")
    p.add_argument("--run-id", action="append", default=[],
                   metavar="QUERY",
                   help="resolve a run through the cross-run registry "
                        "(repeatable, mixes with explicit paths)")
    p.add_argument("--run-dir", default="runs",
                   help="registry location for --run-id resolution")
    args = p.parse_args(argv)

    paths = list(args.paths)
    for query in args.run_id:
        from attacking_federate_learning_tpu_torch.utils.registry import (
            RunRegistry
        )

        entry = RunRegistry(args.run_dir).resolve(query)
        events = entry.get("events")
        if not isinstance(events, str) or not os.path.exists(events):
            p.error(f"--run-id {query}: run {entry['run_id']} has no "
                    f"readable event log (events={events!r})")
        paths.append(events)
    if not paths:
        p.error("nothing to analyze: give RUN_JSONL paths and/or "
                "--run-id")

    failed = False
    results = {}
    for path in paths:
        fx = forensics_summary(load_events([path],
                                           skip_bad=args.skip_bad))
        results[path] = fx
        if fx is None:
            failed = True
    if args.events:
        import time

        from attacking_federate_learning_tpu_torch.utils.metrics import (
            SCHEMA_VERSION, validate_event
        )

        with open(args.events, "a") as f:
            for path, fx in results.items():
                if fx is None:
                    continue
                loc = fx.get("localization", {})
                rec = {"kind": "forensics", "v": SCHEMA_VERSION,
                       "t": round(time.time(), 3), "source": path,
                       "verdict": loc.get("verdict"),
                       "rounds": fx["rounds"],
                       "malicious_shards": fx.get("malicious_shards")}
                if "stabilized_round" in loc:
                    rec["stabilized_round"] = loc["stabilized_round"]
                if "isolated_shards" in loc:
                    rec["isolated_shards"] = loc["isolated_shards"]
                t2 = fx.get("tier2", {})
                if "malicious_share" in t2:
                    rec["tier2_malicious_share"] = t2["malicious_share"]
                    rec["mal_rejected_rounds"] = (
                        t2["mal_rejected_rounds"])
                validate_event(rec)
                f.write(json.dumps(rec) + "\n")
    if args.json:
        print(json.dumps(results))
        return 1 if failed else 0
    for path, fx in results.items():
        print(f"== {path} ==")
        if fx is None:
            print("  no 'shard_selection' events: forensics needs a "
                  "hierarchical (or groupwise-secagg) run with "
                  "--telemetry")
            continue
        _print_forensics(fx, print)
    return 1 if failed else 0


def main(argv=None) -> int:
    if argv is None:
        import sys

        argv = sys.argv[1:]
    if argv and argv[0] == "forensics":
        # 'report forensics' — dispatched before argparse like the
        # cli.py subcommands, so the summary flag surface stays as-is.
        return forensics_main(argv[1:])
    p = argparse.ArgumentParser(
        prog="attacking_federate_learning_tpu_torch report",
        description="Summarize structured run JSONLs: selection "
                    "concentration, phase timing, accuracy/ASR "
                    "trajectories, hierarchical forensics "
                    "(utils/metrics.py event schema).")
    p.add_argument("paths", nargs="*", metavar="RUN_JSONL")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output (one object keyed by "
                        "path)")
    p.add_argument("--no-validate", action="store_true",
                   help="skip schema validation (reading logs from a "
                        "newer/older writer)")
    p.add_argument("--skip-bad", action="store_true",
                   help="tolerate torn/invalid lines (crash-truncated "
                        "logs): skip them with a per-file count instead "
                        "of aborting")
    p.add_argument("--run-id", action="append", default=[],
                   metavar="QUERY",
                   help="resolve a run through the cross-run registry "
                        "(runs/index.jsonl — exact id, unique prefix "
                        "or tag) and report its event log; repeatable, "
                        "mixes with explicit paths")
    p.add_argument("--run-dir", default="runs",
                   help="registry location for --run-id resolution")
    args = p.parse_args(argv)

    paths = list(args.paths)
    for query in args.run_id:
        from attacking_federate_learning_tpu_torch.utils.registry import (
            RunRegistry
        )

        entry = RunRegistry(args.run_dir).resolve(query)
        events = entry.get("events")
        if not isinstance(events, str) or not os.path.exists(events):
            p.error(f"--run-id {query}: run {entry['run_id']} has no "
                    f"readable event log (events={events!r})")
        paths.append(events)
    if not paths:
        p.error("nothing to report: give RUN_JSONL paths and/or --run-id")

    runs = {}
    for path in paths:
        bad: list = []
        runs[path] = summarize_run(
            load_events([path], validate=not args.no_validate,
                        skip_bad=args.skip_bad, bad_lines=bad))
        if bad:
            runs[path]["bad_lines"] = len(bad)

    if args.json:
        print(json.dumps(runs))
        return 0
    for path, s in runs.items():
        _print_run(path, s, print)
    with_sel = {p: s["selection"] for p, s in runs.items()
                if "selection" in s}
    if len(with_sel) > 1:
        print("== selection concentration across runs ==")
        for path, sel in with_sel.items():
            print(f"  top-1 share {sel['top1_share']:.3f}  "
                  f"distinct {sel['distinct_winners']:3d}  "
                  f"malicious {sel['malicious_share']:.3f}  {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
