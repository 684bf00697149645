#!/usr/bin/env python3
"""Where the bf16 route's stage 1 spends its time, on one NVIDIA GPU.

Run from the root of a checkout:  python3 tools/gram_mma_parts.py

Builds csrc/pairwise_distances.cu four times with nvcc, each against a
copy of csrc/gram_mma.cuh with a part of stage 1 cut out: the full
kernel; the copies alone (no realign, no wgmma); the copies and the
realign (no wgmma); the wgmmas alone (no copy, no realign, so they read
whatever shared memory holds).  Each variant's fl_pairwise_distances_bf16
(stage 1 and the epilogue) is timed with CUDA events, median of 15 after
a warm-up, on a seeded bf16 cohort at (10, 8,972,340), (100, 79,510) and
(1,000, 79,510), the variants in turns, twice.  Only the full variant
computes the distances; the others are timings, nothing else.  The builds
go to attacking_federate_learning_tpu_torch/_build/parts/.
"""

import ctypes
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The lines each cut replaces, as gram_mma.cuh has them.
NO_WGMMA = ("    if constexpr (N == 64) wgmma_m64n64(d, a, b, scale_d);",
            "    return;\n    if constexpr (N == 64) "
            "wgmma_m64n64(d, a, b, scale_d);")
NO_REALIGN = ("        realign_chunk(c, c % kRaw, st);", "        ;")
NO_COPIES = [("        if (c < nchunks) load_chunk(c, c);", "        ;"),
             ("        if (c + kAhead < nchunks) load_chunk(c + kAhead, "
              "(c + kAhead) % kRaw);", "        ;")]
VARIANTS = {"full": [], "copies": [NO_WGMMA, NO_REALIGN],
            "copies+realign": [NO_WGMMA],
            "wgmmas": [NO_REALIGN] + NO_COPIES}
SHAPES = ((10, 8_972_340), (100, 79_510), (1000, 79_510))


def build(out_dir):
    from attacking_federate_learning_tpu_torch.ops import _build

    nvcc = _build.nvcc_path()
    if nvcc is None:
        raise SystemExit("gram_mma_parts: no nvcc")
    header = (_build.CSRC / "gram_mma.cuh").read_text()
    procs = {}
    for name, cuts in VARIANTS.items():
        text = header
        for old, new in cuts:
            if text.count(old) != 1:
                raise SystemExit(f"gram_mma_parts: {name}: cannot cut "
                                 f"{old.strip()!r} from gram_mma.cuh")
            text = text.replace(old, new)
        d = os.path.join(out_dir, name.replace("+", "_"))
        os.makedirs(d, exist_ok=True)
        for src in ("gram_tile.cuh", "pairwise_distances.cu"):
            with open(os.path.join(d, src), "w") as f:
                f.write((_build.CSRC / src).read_text())
        with open(os.path.join(d, "gram_mma.cuh"), "w") as f:
            f.write(text)
        lib = os.path.join(d, "parts.so")
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", lib,
             os.path.join(d, "pairwise_distances.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"gram_mma_parts: nvcc {name}:\n{log}")
        libs[name] = lib
    return libs


def main():
    import torch

    if not torch.cuda.is_available():
        print("gram_mma_parts: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from attacking_federate_learning_tpu_torch.ops import _build
    from attacking_federate_learning_tpu_torch.ops.distances import (
        device_gram_plan, gram_workspace
    )

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[parts] {smi}; torch {torch.__version__}", flush=True)
    libs = build(str(_build.BUILD_DIR / "parts"))
    fns = {}
    for name, lib in libs.items():
        fn = ctypes.CDLL(lib).fl_pairwise_distances_bf16
        fn.argtypes = list(_build._GRAM_ARGS)
        fn.restype = ctypes.c_int
        fns[name] = fn
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, d in SHAPES:
        G = torch.randn(n, d, device="cuda", generator=gen).bfloat16()
        plan = device_gram_plan(G)
        ws = gram_workspace(G, plan)
        D = torch.empty(n, n, device="cuda")
        times = {name: [] for name in fns}
        for _ in range(2):
            for name, fn in fns.items():
                def call(fn=fn):
                    status = fn(G.data_ptr(), n, d, *plan.launch_args,
                                ws.data_ptr(), D.data_ptr(),
                                _build.stream_handle(G))
                    _build.check_status(f"parts {name}", status)
                call()
                torch.cuda.synchronize()
                for _ in range(15):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    call()
                    b.record()
                    b.synchronize()
                    times[name].append(a.elapsed_time(b))
        print(f"[parts] n={n} d={d} " + " ".join(
            f"{name}_ms={statistics.median(t):.4f}"
            for name, t in times.items()), flush=True)
        del G, ws, D
    return 0


if __name__ == "__main__":
    sys.exit(main())
