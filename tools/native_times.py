#!/usr/bin/env python3
"""Host times of the native library beside its NumPy plain versions, on
the host of a machine with one NVIDIA GPU.

    python3 tools/native_times.py [N ...]      # default: 100 10000

For each N, one round-0 update matrix of mnist_mlp (d = 79,510) on
SYNTH_MNIST at n = N, f = 24 %, ALIE z = 1.5 (batch 128 at n = 100, 32
above, as chip_smoke.py phases 5 and 17 run them) is made on the card,
with the distance kernel's (n, n) matrix of it (+inf diagonal), and
copied to the host.  On them, host ms (the median of 5 calls up to n =
1,000, one call above) of:

- ``fl_median`` (native) and ``np.median``;
- ``fl_trimmed_mean`` keeping n - f - 1 (native) and the NumPy
  formulation (up to n = 1,000: its stable argsort over the whole matrix
  takes minutes above);
- the argsort of the distance rows (NumPy, the hybrid's host half) and
  ``fl_bulyan_select`` (native), beside ``numpy_bulyan_selection`` (up
  to n = 1,000: O(n^3) in all);
- ``host_krum_index`` (NumPy/BLAS, up to n = 1,000).

Each line names the card and its power limit; the results are checked
equal (the median, the selection) or within 2 n eps max |g| (the trimmed
mean) of the plain versions.
"""

import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def timed(fn, reps):
    ts, out = [], None
    for _ in range(reps):
        a = time.perf_counter()
        out = fn()
        ts.append(1e3 * (time.perf_counter() - a))
    return statistics.median(ts), out


def matrices(n):
    """Round 0's crafted (n, d) matrix and its (n, n) distance matrix,
    as host f32 arrays, and f."""
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
    from attacking_federate_learning_tpu_torch.defenses import kernels as K

    batch = 128 if n <= 100 else 32
    images = max(60_000, n * batch)
    ds = load_dataset(C.SYNTH_MNIST, seed=0, synth_train=images,
                      synth_test=1_000)
    cfg = ExperimentConfig(dataset=C.SYNTH_MNIST, users_count=n,
                           mal_prop=0.24, batch_size=batch, epochs=1,
                           num_std=1.5, defense="Bulyan",
                           synth_train=images, synth_test=1_000)
    exp = FederatedExperiment(cfg, DriftAttack(1.5), ds, device="cuda")
    G = exp.attacker.apply(exp.compute_grads(0), exp.m_mal,
                           exp.attack_context(0))
    D = K.distances_for(G)
    D.fill_diagonal_(math.inf)
    out = G.cpu().numpy(), D.cpu().numpy(), exp.f
    del exp, G, D
    torch.cuda.empty_cache()
    return out


def main(ns):
    sys.path.insert(0, ROOT)
    from attacking_federate_learning_tpu_torch import native as NT
    from attacking_federate_learning_tpu_torch.defenses import host as H
    from attacking_federate_learning_tpu_torch.ops import _build

    smi = smi_line()
    _build.build_all(["pairwise_distances"])
    a = time.perf_counter()
    _build.build_host_library("bulyan_select")
    print(f"[native] g++ build {time.perf_counter() - a:.2f} s; numpy "
          f"{np.__version__}, {os.cpu_count()} cpus; {smi}", flush=True)
    ok = True
    for n in ns:
        G, D, f = matrices(n)
        small = n <= 1_000
        reps = 5 if small else 1
        keep, set_size = n - f - 1, n - 2 * f
        row = {}
        row["fl_median"], med = timed(lambda: NT.native_median(G), reps)
        row["np.median"], med_np = timed(lambda: np.median(G, 0), reps)
        ok &= bool(np.array_equal(med, med_np.astype(np.float32)))
        row["fl_trimmed_mean"], tm = timed(
            lambda: NT.native_trimmed_mean(G, keep), reps)
        row["argsort (NumPy)"], order = timed(
            lambda: np.argsort(D, axis=1).astype(np.int32), reps)
        row["fl_bulyan_select"], sel = timed(
            lambda: NT.native_bulyan_selection(D, order, n, f, set_size),
            reps)
        if small:
            band = 2.0 * n * float(np.finfo(np.float32).eps) * float(
                np.abs(G).max())
            row["trimmed mean (NumPy)"], tm_np = timed(
                lambda: _numpy_trimmed_mean(G, keep), reps)
            ok &= bool(np.abs(tm - tm_np).max() <= band)
            row["numpy_bulyan_selection"], sel_np = timed(
                lambda: H.numpy_bulyan_selection(D, order, n, f, set_size),
                reps)
            ok &= bool(np.array_equal(sel, sel_np))
            row["host_krum_index (NumPy/BLAS)"] = timed(
                lambda: H.host_krum_index(G, n, f), reps)[0]
        print(f"[native] ({n}, {G.shape[1]}) f={f} host ms (median of "
              f"{reps}): " + ", ".join(f"{k} {v:.3f}"
                                        for k, v in row.items())
              + f"; checks ok={ok}; {smi}", flush=True)
        del G, D
    return 0 if ok else 1


def _numpy_trimmed_mean(G, k):
    """The trimmed mean's NumPy formulation, the native kernel's plain
    version."""
    med = np.median(G, axis=0)
    dev = G - med
    order = np.argsort(np.abs(dev), axis=0, kind="stable")
    return (np.take_along_axis(dev, order[:k], axis=0).mean(axis=0)
            + med).astype(np.float32)


if __name__ == "__main__":
    sys.exit(main([int(a) for a in sys.argv[1:]] or [100, 10_000]))
