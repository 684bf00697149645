"""Runners for the BASELINE benchmark configs.

The port's copy of the JAX package's ``benchmarks.py``: the five
benchmark configurations of BASELINE.md (from BASELINE.json), each run
end to end through the real engine, one JSON line per cell (rounds/sec,
final accuracy, ASR where applicable):

    python -m attacking_federate_learning_tpu_torch.benchmarks --rounds 10

The cells run on the card unless ``--device cpu`` asks for the CPU; the
kernel libraries build on first use.  ``--scale`` shrinks client counts
(defaults to 1.0 on the card, 0.1 on the CPU — the shapes stay faithful,
only n shrinks); ``--cells`` selects a subset.  Cell 5 (the 10k-client
non-IID grid) is the overnight north star and only runs when asked for
explicitly.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _cells():
    from attacking_federate_learning_tpu_torch import config as C

    # (name, cfg overrides, attack, baseline.json description)
    return [
        ("ref_default",
         dict(dataset=C.MNIST, users_count=10, mal_prop=0.0,
              defense="NoDefense"),
         "none",
         "MNIST MLP, 10 clients, FedAvg (no attack) - reference default"),
        ("mnist_cnn_krum_alie",
         dict(dataset=C.MNIST, model="mnist_cnn", users_count=100,
              mal_prop=0.24, defense="Krum"),
         "alie",
         "MNIST CNN, 100 clients, Krum vs ALIE"),
        ("cifar10_resnet20_trimmed_backdoor",
         dict(dataset=C.CIFAR10, model="resnet20", users_count=100,
              mal_prop=0.24, defense="TrimmedMean", backdoor="pattern",
              batch_size=32),
         "backdoor",
         "CIFAR-10 ResNet-20, 100 clients, trimmed_mean vs backdoor"),
        ("cifar10_bulyan_alie_1000c",
         dict(dataset=C.CIFAR10, users_count=1000, mal_prop=0.2,
              defense="Bulyan", batch_size=32),
         "alie",
         "CIFAR-10, 1000 clients, Bulyan vs ALIE - O(n^2 d) stress"),
        ("noniid_10k_grid",
         # bulyan_selection_impl='host': at full scale the exact selection
         # is ~5,200 sequential O(n^2) trips PER ROUND; the hybrid (card
         # Gram -> one (n, n) copy -> native selection) is the affordable
         # exact-semantics route on both devices.
         dict(dataset=C.MNIST, users_count=10_000, mal_prop=0.24,
              partition="dirichlet", batch_size=32,
              data_placement="host_stream",
              bulyan_selection_impl="host"),
         "grid",
         "non-IID, 10k clients, {Krum,TrimmedMean,Bulyan} x "
         "{ALIE,backdoor} grid - overnight north star"),
    ]


def run_cell(name, overrides, attack, rounds, scale, log_dir,
             device="cuda"):
    from attacking_federate_learning_tpu_torch.attacks import make_attacker
    from attacking_federate_learning_tpu_torch.config import (
        ExperimentConfig
    )
    from attacking_federate_learning_tpu_torch.core.engine import (
        FederatedExperiment
    )
    from attacking_federate_learning_tpu_torch.data.datasets import (
        load_dataset
    )
    from attacking_federate_learning_tpu_torch.grid import run_grid
    from attacking_federate_learning_tpu_torch.utils.profiling import (
        synchronize
    )

    overrides = dict(overrides)
    overrides["users_count"] = max(4, int(overrides["users_count"] * scale))
    cfg = ExperimentConfig(epochs=rounds, log_dir=log_dir,
                           synth_train=4096, synth_test=512, **overrides)
    t0 = time.time()
    if attack == "grid":
        cells = run_grid(cfg, defenses=["Krum", "TrimmedMean", "Bulyan"],
                         attacks=["alie", "backdoor"], device=device)
        return {"cell": name, "clients": cfg.users_count,
                "wall_s": round(time.time() - t0, 2),
                "grid_cells": len(cells),
                "final_accuracies": {f"{c['defense']}/{c['attack']}":
                                     c.get("final_accuracy")
                                     for c in cells}}
    ds = load_dataset(cfg.dataset, cfg.data_dir, cfg.seed,
                      synth_train=cfg.synth_train, synth_test=cfg.synth_test)
    attacker = make_attacker(cfg, dataset=ds,
                             name=None if cfg.backdoor else attack,
                             device=device)
    exp = FederatedExperiment(cfg, attacker=attacker, dataset=ds,
                              device=device)
    # Warm round first: rounds_per_sec reports steady-state throughput,
    # not the kernels' build, cuDNN's first calls and dataset synthesis
    # (those go to setup_s).
    exp.run_round(0)
    synchronize(exp.state.weights)
    setup_s = time.time() - t0
    t1 = time.time()
    for t in range(1, 1 + rounds):
        exp.run_round(t)
    synchronize(exp.state.weights)
    wall = time.time() - t1
    _, correct = exp.evaluate(exp.state.weights)
    out = {"cell": name, "clients": cfg.users_count, "rounds": rounds,
           "dataset": ds.name, "model": cfg.model,
           "rounds_per_sec": round(rounds / wall, 3),
           "setup_s": round(setup_s, 2), "wall_s": round(wall, 2),
           "final_accuracy": round(100 * float(correct)
                                   / len(ds.test_y), 2)}
    if cfg.backdoor and hasattr(attacker, "test_asr"):
        out["asr"] = round(float(attacker.test_asr(exp.state.weights)), 2)
    return out


def main(argv=None):
    from attacking_federate_learning_tpu_torch.core.engine import (
        resolve_device
    )

    p = argparse.ArgumentParser(
        prog="attacking_federate_learning_tpu_torch.benchmarks",
        description=__doc__)
    p.add_argument("--rounds", type=int, default=10)
    p.add_argument("--scale", type=float, default=None,
                   help="client-count multiplier (default 1.0 on the "
                        "card, 0.1 on the CPU)")
    p.add_argument("--cells", type=str, default=None,
                   help="comma-separated 1-based cell indices; default "
                        "1,2,3,4 on the card, 1,2,4 on the CPU (cell 3's "
                        "ResNet shadow training is impractical on a few "
                        "CPU cores; 5 = the 10k grid north star)")
    p.add_argument("--log-dir", type=str, default="logs")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where every cell runs (default: the card; no "
                        "cell falls back to the CPU)")
    p.add_argument("--strict", dest="strict", action="store_true",
                   default=True,
                   help="exit nonzero if any requested cell failed "
                        "(default: on — an unattended end-of-round sweep "
                        "must distinguish 'failed' from 'not requested')")
    p.add_argument("--no-strict", dest="strict", action="store_false")
    args = p.parse_args(argv)

    on_accel = resolve_device(args.device).type == "cuda"
    scale = args.scale if args.scale is not None else (
        1.0 if on_accel else 0.1)
    cells_arg = args.cells or ("1,2,3,4" if on_accel else "1,2,4")
    wanted = {int(x) for x in cells_arg.split(",")}
    results = []
    for i, (name, overrides, attack, desc) in enumerate(_cells(), 1):
        if i not in wanted:
            continue
        if name == "noniid_10k_grid" and not on_accel:
            # The JAX package's CPU policy (BASELINE.md round 5): in the
            # 10k regime the benchmark opts into the native host trimmed
            # means, which take seconds a round where a sort of the
            # (n, d) matrix on the CPU takes minutes.
            overrides = dict(overrides, trimmed_mean_impl="host",
                             bulyan_trim_impl="host")
        print(f"# cell {i}: {desc} (scale {scale})", file=sys.stderr,
              flush=True)
        try:
            cell = run_cell(name, overrides, attack, args.rounds, scale,
                            args.log_dir, args.device)
        except Exception as e:  # record, keep going
            cell = {"cell": name, "failed": f"{type(e).__name__}: {e}"}
        results.append(cell)
        print(json.dumps(cell), flush=True)
    failed = [c["cell"] for c in results if "failed" in c]
    if args.strict and failed:
        # Loud failure for unattended sweeps: a failed cell must not look
        # like an unrequested one.  The full result list (successful
        # cells included) rides on the exception for programmatic
        # callers that catch SystemExit.
        err = SystemExit(
            f"benchmarks: {len(failed)} cell(s) failed: {', '.join(failed)}")
        err.results = results
        raise err
    return results


if __name__ == "__main__":
    main()
