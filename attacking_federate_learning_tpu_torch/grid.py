"""Attack x defense grid runner: a thin campaign-spec wrapper.

The port's copy of the JAX package's ``grid.py``.  It compiles its flag
surface into a :class:`CampaignSpec` (campaigns/spec.py) and delegates
to the campaign engine's inline executor (campaigns/scheduler.py) on the
card (``--device cpu`` asks for the CPU), keeping the historical
contract: cells run in spec order in ONE process (datasets shared),
every cell appends one JSON line to the summary as it finishes, and
composition rejections record as skipped cells instead of killing the
sweep:

    python -m attacking_federate_learning_tpu_torch.grid --epochs 100 -s MNIST

Cell ids are ``cell_id_for(cfg, attack)``: the config-hash
``run_id_for`` join key extended with the attack name.  Under
``--journal`` the sweep becomes a persisted campaign: exactly-once cell
accounting under ``runs/campaigns/<id>/``, per-run journals and registry
stamps (so ``runs campaign <id>`` renders the grid table straight from
the registry), and a re-invoke completes only the remaining cells.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from attacking_federate_learning_tpu_torch import config as C
from attacking_federate_learning_tpu_torch.config import ExperimentConfig


def _all_defenses():
    # Derived from the registry so new defenses join the sweep on
    # registration (sorted; NoDefense first as the baseline column).
    from attacking_federate_learning_tpu_torch.defenses import DEFENSES
    names = sorted(DEFENSES)
    return ["NoDefense"] + [n for n in names if n != "NoDefense"]


def _all_attacks():
    from attacking_federate_learning_tpu_torch.attacks import ATTACKS
    names = ATTACKS.names()
    return ["none"] + [n for n in names if n != "none"]


def grid_spec(base: ExperimentConfig, defenses=None,
              attacks=None) -> "CampaignSpec":
    """The grid flag surface as a campaign spec (defense x attack axes
    over the base config)."""
    from attacking_federate_learning_tpu_torch.campaigns.spec import (
        CampaignSpec
    )

    return CampaignSpec(
        name="grid",
        base=dataclasses.asdict(base),
        axes={"defense": list(defenses or _all_defenses()),
              "attack": list(attacks or _all_attacks())},
        order="spec")


def _grid_row(cell, row) -> dict:
    """One campaign cell record in the historical grid summary shape."""
    rec = {"defense": (cell.cfg.defense if cell.cfg is not None
                       else cell.overrides.get("defense")),
           "attack": cell.attack}
    state = row["state"]
    if state == "skipped":
        rec["skipped"] = row.get("reason")
        if cell.cfg is not None:  # config-level rejections have no
            rec["run_id"] = cell.cell_id  # config hash to join on
        return rec
    rec["run_id"] = cell.cell_id
    if state == "failed":
        rec["failed"] = row.get("reason")
        rec["wall_s"] = row.get("wall_s")
        return rec
    rec["final_accuracy"] = row.get("final_accuracy")
    rec["max_accuracy"] = row.get("max_accuracy")
    rec["rounds"] = row.get("rounds")
    rec["wall_s"] = row.get("wall_s")
    if "final_asr" in row:
        rec["final_asr"] = row["final_asr"]
    return rec


def run_grid(base: ExperimentConfig, defenses=None, attacks=None,
             out_path=None, journal=False, order="spec", device="cuda"):
    """Run the grid as an inline campaign on ``device``; returns the
    summary rows.

    ``journal=False`` (the historical default) keeps the sweep
    ephemeral — no runs/ artifacts, just the summary JSONL;
    ``journal=True`` persists the campaign journal + per-run journals
    and makes the sweep resumable."""
    from attacking_federate_learning_tpu_torch.campaigns.scheduler import (
        Campaign
    )

    spec = grid_spec(base, defenses, attacks)
    os.makedirs(base.log_dir, exist_ok=True)
    out_path = out_path or os.path.join(base.log_dir, "grid_summary.jsonl")
    results = []
    summary = open(out_path, "w")

    def on_cell(cell, row):
        # Append per cell so a failing cell can't discard finished
        # results (the historical incremental-summary contract).
        rec = _grid_row(cell, row)
        results.append(rec)
        summary.write(json.dumps(rec) + "\n")
        summary.flush()
        print(json.dumps(rec), flush=True)

    camp = Campaign(spec, executor="inline", order=order,
                    journal_runs=journal, persist=journal,
                    on_cell=on_cell, device=device)
    try:
        camp.run()
    finally:
        summary.close()
    return results


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="attacking_federate_learning_tpu_torch.grid",
        description="attack x defense grid")
    p.add_argument("-s", "--dataset", default=C.SYNTH_MNIST)
    p.add_argument("-n", "--users-count", default=10, type=int)
    p.add_argument("-m", "--mal-prop", default=0.24, type=float)
    p.add_argument("-e", "--epochs", default=50, type=int)
    p.add_argument("-c", "--batch_size", default=128, type=int)
    p.add_argument("--defenses", nargs="*", default=None)
    p.add_argument("--attacks", nargs="*", default=None)
    p.add_argument("--secagg", default="off",
                   choices=["off", "vanilla", "groupwise"],
                   help="secure-aggregation visibility mode for every "
                        "cell (protocols/secagg.py); incompatible "
                        "defense cells record as skipped")
    p.add_argument("--aggregation", default="flat",
                   choices=["flat", "hierarchical"])
    p.add_argument("--megabatch", default=0, type=int)
    p.add_argument("--tier2-defense", default=None,
                   choices=["NoDefense", "Krum", "TrimmedMean", "Bulyan",
                            "Median"])
    p.add_argument("--mal-placement", default="spread",
                   choices=["spread", "concentrated"])
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where every cell runs (default: the card)")
    p.add_argument("--synth-train", default=ExperimentConfig.synth_train,
                   type=int)
    p.add_argument("--synth-test", default=ExperimentConfig.synth_test,
                   type=int)
    p.add_argument("--log-dir", default="logs", type=str)
    p.add_argument("--run-dir", default="runs", type=str,
                   help="campaign + run journal root (used with "
                        "--journal)")
    p.add_argument("--out", default=None, type=str,
                   help="summary JSONL path (default <log-dir>/"
                        "grid_summary.jsonl)")
    p.add_argument("--journal", action="store_true",
                   help="persist the sweep as a campaign: exactly-once "
                        "cell accounting under runs/campaigns/<id>/, "
                        "per-run journals + registry stamps, resumable "
                        "re-invocation ('runs campaign <id>' renders "
                        "the table)")
    p.add_argument("--order", default="spec",
                   choices=["spec", "grouped", "shuffled"],
                   help="cell execution order (campaigns/scheduler.py; "
                        "'spec' preserves the historical product order)")
    args = p.parse_args(argv)

    base = ExperimentConfig(dataset=args.dataset,
                            users_count=args.users_count,
                            mal_prop=args.mal_prop, epochs=args.epochs,
                            batch_size=args.batch_size, seed=args.seed,
                            log_dir=args.log_dir,
                            run_dir=args.run_dir,
                            synth_train=args.synth_train,
                            synth_test=args.synth_test,
                            secagg=args.secagg,
                            aggregation=args.aggregation,
                            megabatch=args.megabatch,
                            tier2_defense=args.tier2_defense,
                            mal_placement=args.mal_placement)
    run_grid(base, args.defenses, args.attacks, out_path=args.out,
             journal=args.journal, order=args.order, device=args.device)


if __name__ == "__main__":
    main()
