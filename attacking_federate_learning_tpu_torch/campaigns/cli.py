"""Campaign driver CLI of the port.

    python -m attacking_federate_learning_tpu_torch.campaigns spec.json \
        [--executor supervisor|inline] [--order grouped|spec|shuffled] \
        [--cache-dir D --cache-budget-mb N] [--deadline SECS] [--dry-run] \
        [--device cuda|cpu]

Also dispatched as ``... cli campaign <spec.json> ...`` (cli.py).  The
spec is a CampaignSpec JSON (campaigns/spec.py), the JAX package's
format.  Cells run on the card unless ``--device cpu`` asks for the
CPU.  Exit status: 0 = every cell done or skipped, 1 = some cell failed
(or a bad spec, or a campaign directory holding the JAX package's
journal of this spec), 75 = stopped cleanly at the wall-clock deadline
(re-invoke to continue — the campaign journal resumes only the
remaining cells).
"""

from __future__ import annotations

import argparse


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="attacking_federate_learning_tpu_torch campaign",
        description="Run a declarative defense x attack x topology "
                    "sweep as a resumable, cache-aware campaign "
                    "(campaigns/scheduler.py).")
    p.add_argument("spec", help="CampaignSpec JSON path")
    p.add_argument("--executor", default="supervisor",
                   choices=["supervisor", "inline"],
                   help="'supervisor' runs each cell as a child under "
                        "the port's supervisor (bounded retries, journal "
                        "audit — the durable default); 'inline' runs "
                        "cells in-process, grid-style (shared datasets, "
                        "fastest for small cells)")
    p.add_argument("--order", default=None,
                   choices=["grouped", "spec", "shuffled"],
                   help="cell ordering (default: the spec's; 'grouped' "
                        "= priority bands, config-signature groups "
                        "adjacent inside each; 'shuffled' is the "
                        "deterministic control arm)")
    p.add_argument("--run-dir", default=None,
                   help="campaign + run store root (default: the "
                        "spec base's run_dir, else 'runs')")
    p.add_argument("--cache-dir", default=None,
                   help="kernel-library build directory pinned onto "
                        "every cell (default: the package's _build/)")
    p.add_argument("--cache-budget-mb", default=0.0, type=float,
                   help="evict least-recently-used build files "
                        "between cells to stay under this many MB "
                        "(0 = unbounded; needs --cache-dir)")
    p.add_argument("--deadline", default=None, type=float,
                   metavar="SECS",
                   help="wall-clock budget for THIS invocation: past "
                        "it the campaign checkpoints cleanly and exits "
                        "75")
    p.add_argument("--max-retries", default=2, type=int,
                   help="per-cell supervisor retry budget")
    p.add_argument("--no-journal-runs", action="store_true",
                   help="inline executor only: run cells without "
                        "per-run journals/registry stamps")
    p.add_argument("--no-cost-report", action="store_true",
                   help="supervisor executor: do not force "
                        "--cost-report onto cells (drops the per-cell "
                        "library build/load evidence)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where every cell runs (default: the card)")
    p.add_argument("--dry-run", action="store_true",
                   help="print the validated, ordered plan and exit")
    args = p.parse_args(argv)

    from attacking_federate_learning_tpu_torch.campaigns.scheduler import (
        Campaign
    )
    from attacking_federate_learning_tpu_torch.campaigns.spec import (
        CampaignSpec
    )

    try:
        spec = CampaignSpec.load(args.spec)
    except (OSError, ValueError, TypeError) as e:
        print(f"campaign: bad spec {args.spec}: {e}")
        return 1
    camp = Campaign(spec, run_dir=args.run_dir,
                    executor=args.executor, order=args.order,
                    cache_dir=args.cache_dir,
                    cache_budget_mb=args.cache_budget_mb,
                    max_retries=args.max_retries,
                    deadline_s=args.deadline,
                    journal_runs=not args.no_journal_runs,
                    cost_report=not args.no_cost_report,
                    device=args.device)
    try:
        cells = camp.plan()
    except ValueError as e:
        print(f"campaign: bad spec {args.spec}: {e}")
        return 1
    if args.dry_run:
        print(f"== campaign {spec.campaign_id}: {len(cells)} cells, "
              f"order={camp.order}, executor={camp.executor_name} ==")
        for i, c in enumerate(cells):
            state = camp.journal.state_of(c.cell_id)
            note = (f"SKIP: {c.skip}" if c.skip else state)
            print(f"  {i:3d}  [{c.group}] p{c.priority}  "
                  f"{c.cell_id}  {note}")
        return 0
    rc = camp.run()
    man = camp.journal.read_manifest() or {}
    counts = man.get("counts", {})
    print(f"[campaign] {spec.campaign_id}: {man.get('status', '?')}  "
          + "  ".join(f"{k}={v}" for k, v in sorted(counts.items()))
          + f"  cache={man.get('cache', {})}")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
