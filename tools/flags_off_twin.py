#!/usr/bin/env python3
"""Two trees of the port, one set of flags-off runs: are they the same
bits and the same launches?  On one NVIDIA GPU.

    python3 tools/flags_off_twin.py run ROOT OUT.npz
    python3 tools/flags_off_twin.py compare A.npz B.npz

``run`` imports the port from the checkout at ROOT (for instance a
parent commit unpacked with ``git archive``), builds its kernels, runs
nine configurations with every observatory flag off through run() on
the card (mnist_mlp on SYNTH_MNIST 60,000 / 10,000, ALIE z = 1.5:
NoDefense, Krum, TrimmedMean, Bulyan and Median at n = 100, f = 24,
21 rounds; Krum and TrimmedMean with dropout, stragglers and NaN
corruption at f = 10; async Krum 'poly' at k = 64; hierarchical
Median/Median at n = 1,000 in ten megabatches, 6 rounds) and saves
each run's final weights and velocity and its kernel launches.
``compare`` holds two saved runs byte for byte and launch for launch
and exits 1 on any difference.  Run both trees in one call, on one
card.
"""

import json
import sys

import numpy as np


def configs(C, FaultConfig):
    base = dict(dataset=C.SYNTH_MNIST, users_count=100, batch_size=128,
                epochs=21, num_std=1.5, learning_rate=0.1, momentum=0.9,
                test_step=10, synth_train=60_000, synth_test=10_000)
    fc = dict(dropout=0.1, straggler=0.1, straggler_delay=2, corrupt=0.05)
    out = {}
    for d in ("NoDefense", "Krum", "TrimmedMean", "Bulyan", "Median"):
        out[d] = dict(base, defense=d, mal_prop=0.24)
    for d in ("Krum", "TrimmedMean"):
        out[d + "-faulted"] = dict(base, defense=d, mal_prop=0.1,
                                   faults=FaultConfig(**fc))
    out["async-Krum"] = dict(base, defense="Krum", mal_prop=0.24,
                             aggregation="async", async_buffer=64,
                             async_max_staleness=2, staleness_weight="poly")
    out["hier-Median"] = dict(base, users_count=1000, batch_size=32,
                              epochs=6, test_step=5, defense="Median",
                              mal_prop=0.24, aggregation="hierarchical",
                              megabatch=100, tier2_defense="Median")
    return out


def run(root, out):
    sys.path.insert(0, root)
    import torch

    from attacking_federate_learning_tpu_torch import config as C
    from attacking_federate_learning_tpu_torch.attacks import DriftAttack
    from attacking_federate_learning_tpu_torch.config import (
        ExperimentConfig, FaultConfig
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
    arrays, launches = {}, {}
    for name, kw in configs(C, FaultConfig).items():
        exp = FederatedExperiment(ExperimentConfig(**kw), DriftAttack(1.5),
                                  ds, device="cuda")
        _build.reset_launches()
        exp.run(log=lambda s: None)
        torch.cuda.synchronize()
        launches[name] = {k: v for k, v in _build.LAUNCHES.items() if v}
        arrays[name + ".w"] = exp.state.weights.cpu().numpy()
        arrays[name + ".v"] = exp.state.velocity.cpu().numpy()
        print(name, launches[name], flush=True)
    np.savez(out, launches=json.dumps(launches), **arrays)


def compare(a, b) -> bool:
    A, B = np.load(a), np.load(b)
    la, lb = json.loads(str(A["launches"])), json.loads(str(B["launches"]))
    ok = set(la) == set(lb)
    for name in la:
        same = all(A[name + s].view(np.int32).tobytes()
                   == B[name + s].view(np.int32).tobytes()
                   for s in (".w", ".v"))
        print(f"[flags-off twin] {name:19s} weights+velocity byte-equal "
              f"{same} launches equal {la[name] == lb.get(name)} "
              f"{la[name]}")
        ok = ok and same and la[name] == lb.get(name)
    print("[flags-off twin] all equal", ok)
    return ok


if __name__ == "__main__":
    if sys.argv[1] == "run":
        run(sys.argv[2], sys.argv[3])
    else:
        sys.exit(0 if compare(sys.argv[2], sys.argv[3]) else 1)
