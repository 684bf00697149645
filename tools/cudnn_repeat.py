#!/usr/bin/env python3
"""Does a cifar10_cnn run repeat on the card?  On one NVIDIA GPU.

    python3 tools/cudnn_repeat.py

Runs cifar10_cnn (TrimmedMean, n = 100, f = 24, ALIE z = 1.5, batch 32,
augmented, SYNTH_CIFAR10 20,000 / 2,000) for 5 rounds three times with
cuDNN's default convolution algorithms and three times with its
deterministic ones (``torch.backends.cudnn.deterministic``): two runs
with the training set on the device and one streamed from the host
(prefetch 2, one worker).  Prints, for each setting, whether the second
device run and the streamed run are byte-equal to the first (and the
largest weight difference) and each run's ms a round (host clock,
synchronised; the first run's includes the warm-up).  The engines set
the deterministic flag themselves (core/engine.py:resolve_device), so
the script sets it after each engine is made.  Exits 1 if a
deterministic run does not repeat.
"""

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
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

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    _build.build_all(["trimmed_mean"])
    ds = load_dataset(C.SYNTH_CIFAR10, seed=0, synth_train=20_000,
                      synth_test=2_000)

    def run(deterministic, **kw):
        cfg = ExperimentConfig(
            dataset=C.SYNTH_CIFAR10, users_count=100, mal_prop=0.24,
            batch_size=32, epochs=5, num_std=1.5, learning_rate=0.1,
            momentum=0.9, defense="TrimmedMean", data_augment=True,
            synth_train=20_000, synth_test=2_000, **kw)
        exp = FederatedExperiment(cfg, DriftAttack(1.5), ds, device="cuda")
        torch.backends.cudnn.deterministic = deterministic
        torch.cuda.synchronize()
        a = time.perf_counter()
        for t in range(cfg.epochs):
            exp.run_round(t)
        torch.cuda.synchronize()
        return exp, 1e3 * (time.perf_counter() - a) / cfg.epochs

    def same(a, b):
        w = [(x.state.weights, x.state.velocity) for x in (a, b)]
        equal = all(torch.equal(p.view(torch.int32), q.view(torch.int32))
                    for p, q in zip(*w))
        return equal, float((a.state.weights - b.state.weights).abs().max())

    ok = True
    for det in (False, True):
        first, ms1 = run(det)
        second, ms2 = run(det)
        streamed, ms3 = run(det, data_placement="host_stream",
                            stream_prefetch=2, stream_workers=1)
        streamed.stream.close()
        rep, strm = same(first, second), same(first, streamed)
        ok &= (not det) or (rep[0] and strm[0])
        print(f"[cudnn] deterministic={det}: second device run byte-equal="
              f"{rep[0]} (max |dw| {rep[1]:.3g}), streamed byte-equal="
              f"{strm[0]} (max |dw| {strm[1]:.3g}); ms a round "
              f"{ms1:.3f} / {ms2:.3f} / {ms3:.3f}; {smi}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
