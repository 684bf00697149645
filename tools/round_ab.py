#!/usr/bin/env python3
"""Flags-off round time of one tree of the port, on one NVIDIA GPU.

    python3 tools/round_ab.py ROOT LABEL

imports the port from the checkout at ROOT (for instance a parent commit
unpacked with ``git archive``), builds its kernels and runs mnist_mlp on
SYNTH_MNIST 60,000 / 10,000 at n = 100, f = 24, ALIE z = 1.5 under Krum,
TrimmedMean, Median and Bulyan with every observability flag off: 41
rounds through run_round, each synchronised and timed on the host clock
(the median and quartiles of rounds 1..40 printed), then 41 rounds
through run() (their seconds, evaluations and boundaries included).
Compare two trees inside one call, on one card, in turns: parent,
change, change, parent.
"""

import statistics
import sys
import time


def main(root: str, label: str) -> None:
    sys.path.insert(0, root)
    import torch

    from attacking_federate_learning_tpu_torch import config as C
    from attacking_federate_learning_tpu_torch.attacks import DriftAttack
    from attacking_federate_learning_tpu_torch.config import (
        ExperimentConfig
    )
    from attacking_federate_learning_tpu_torch.core.engine import (
        FederatedExperiment
    )
    from attacking_federate_learning_tpu_torch.data.datasets import (
        load_dataset
    )
    from attacking_federate_learning_tpu_torch.ops import _build

    _build.build_all()
    ds = load_dataset(C.SYNTH_MNIST, seed=0, synth_train=60_000,
                      synth_test=10_000)
    for d in ("Krum", "TrimmedMean", "Median", "Bulyan"):
        cfg = ExperimentConfig(
            dataset=C.SYNTH_MNIST, users_count=100, mal_prop=0.24,
            batch_size=128, epochs=41, num_std=1.5, learning_rate=0.1,
            momentum=0.9, defense=d, test_step=10, synth_train=60_000,
            synth_test=10_000)
        exp = FederatedExperiment(cfg, DriftAttack(1.5), ds, device="cuda")
        ts = []
        for t in range(41):
            torch.cuda.synchronize()
            a = time.perf_counter()
            exp.run_round(t)
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - a))
        exp2 = FederatedExperiment(cfg, DriftAttack(1.5), ds, device="cuda")
        torch.cuda.synchronize()
        a = time.perf_counter()
        exp2.run(log=lambda s: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - a
        q = statistics.quantiles(ts[1:], n=4)
        print(f"[ab] {label:6s} {d:12s} round_ms median="
              f"{statistics.median(ts[1:]):.3f} q1={q[0]:.3f} "
              f"q3={q[2]:.3f} run_41_rounds_s={wall:.3f}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
