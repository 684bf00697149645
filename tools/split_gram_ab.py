"""The split Gram's entry points on the card, for one tree of the repo.

    python3 tools/split_gram_ab.py run ROOT LABEL
    python3 tools/split_gram_ab.py host ROOT LABEL
    python3 tools/split_gram_ab.py phase21 ROOT LABEL
    python3 tools/split_gram_ab.py sweep
    python3 tools/split_gram_ab.py sass ROOT_A ROOT_B

``run`` imports the port from ROOT (this tree or a parent unpacked with
``git archive`` into a gitignored directory), builds its distance
kernels there, and times at chip_smoke.py's phase 21 (a) shapes, on
seeded ALIE cohorts: stage 1 on the first column block (``gram_partials``,
its route by dtype), the epilogue over the m blocks' outputs, the whole
split route (m stage-1 calls and the epilogue), the fused
``pairwise_distances`` on the whole matrix and ``torch.mm`` on the block
(f32 out for bf16).  Each as ms (CUDA events, one call, median of 20,
the wrapper's host work included) and as device us (torch.profiler, the
kernels one call launches, mean over 20 calls).  Run parent, change,
change, parent in one call to compare two trees on one card.  One line
a measurement: ``[ab] LABEL shape what ms=... us=...``.

``host`` times, with the card idle, how long the split wrappers and
their pieces (the plan, the allocation, the stream handle, the C entry
point alone) hold the host, and the same for the fused kernel and
``torch.mm``.

``phase21`` runs ROOT's own chip_smoke.py phase 21 (a) (``p21_kernels``)
alone after building ROOT's distance kernels, and prints its failures.

``sweep`` (this tree) times stage 1 under forced split plans, chains x
clusters x slices, at (100, 39,755) f32 and bf16 and (100, 5,460) f32,
in device us, beside the plan ``split_plan`` picks on this card.

``sass`` dumps each tree's distance libraries with cuobjdump and says
whether every kernel the fused entry points launch (gram_partials_kernel,
gram_mma_kernel, gram_epilogue_kernel, and the Krum kernels) has the
same SASS in both, ignoring addresses.
"""

from __future__ import annotations

import importlib
import re
import statistics
import subprocess
import sys
from pathlib import Path

SHAPES = ((100, 79_510, 2, "float32"), (100, 79_510, 2, "bfloat16"),
          (100, 21_840, 4, "float32"))
REPS = 20


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip()


def cohort(n, d, f, seed):
    """Seeded (n, d) f32 rows with the first f crafted as ALIE crafts
    them (identical rows)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, d), dtype=np.float32)
    honest = G[f:]
    G[:f] = honest.mean(0) - 1.5 * honest.std(0)
    return G


def time_ms(fn):
    import torch

    fn()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_us(fn, tries=3):
    """Device time of the kernels and copies one call launches (mean over
    REPS calls) and their names; a capture that lost events (a count not
    a multiple of REPS) is taken again, and after ``tries`` reads as
    None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if e.device_time_total > 0]
        if rows and all(e.count % REPS == 0 for e in rows):
            total = sum(e.device_time_total for e in rows) / REPS
            return total, sorted(
                f"{e.key[:40]} x{e.count // REPS} "
                f"{e.device_time_total / REPS:.1f} us" for e in rows)
    return None, []


def load(root):
    sys.path.insert(0, str(Path(root).resolve()))
    pkg = "attacking_federate_learning_tpu_torch"
    build = importlib.import_module(f"{pkg}.ops._build")
    dist = importlib.import_module(f"{pkg}.ops.distances")
    assert Path(dist.__file__).resolve().is_relative_to(
        Path(root).resolve()), dist.__file__
    build.build_all(["pairwise_distances", "krum_scores"])
    return build, dist


def run(root, label):
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    _, DI = load(root)
    print(f"[ab] {label} root={root} on {smi()}", flush=True)
    for n, d, m, dt in SHAPES:
        dtype = getattr(torch, dt)
        G = torch.from_numpy(cohort(n, d, 24, 2)).cuda().to(dtype)
        blocks = [b.contiguous() for b in torch.tensor_split(G, m, dim=1)]
        b0 = blocks[0]
        parts = [DI.gram_partials(b) for b in blocks]
        shape = f"({n}, {d:,}) {dt} m={m}"
        mm = ((lambda: torch.mm(b0, b0.T, out_dtype=torch.float32))
              if dtype == torch.bfloat16 else (lambda: torch.mm(b0, b0.T)))
        calls = {
            "stage1": lambda: DI.gram_partials(b0),
            "epilogue": lambda: DI.gram_epilogue(parts),
            "route": lambda: DI.gram_epilogue(
                [DI.gram_partials(b) for b in blocks]),
            "fused": lambda: DI.pairwise_distances(G),
            "torch.mm": mm,
        }
        for what, fn in calls.items():
            ms = time_ms(fn)
            us, names = device_us(fn)
            print(f"[ab] {label} {shape} {what:8s} ms={ms:.4f} "
                  f"us={'not measured' if us is None else f'{us:.1f}'} "
                  f"kernels={names}", flush=True)
        del G, blocks, parts
        torch.cuda.empty_cache()


def host_us(fn, reps=200):
    """Median host time (us) of one call with the card idle: synchronise,
    then time the call's return (what it enqueues runs after)."""
    import time

    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def host(root, label):
    """Host time of the split wrappers and of their pieces."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    build, DI = load(root)
    n, d = 100, 39_755
    G = torch.from_numpy(cohort(n, 2 * d, 24, 2)).cuda()
    b0 = G[:, :d].contiguous()
    parts = [DI.gram_partials(b0), DI.gram_partials(b0)]
    name = "gram_partials"
    fn = build.entry_point(name)
    calls = {
        "gram_partials": lambda: DI.gram_partials(b0),
        "gram_epilogue": lambda: DI.gram_epilogue(parts),
        "pairwise_distances": lambda: DI.pairwise_distances(G),
        "torch.mm": lambda: torch.mm(b0, b0.T),
        "torch.empty": lambda: torch.empty(n * n, device=b0.device),
        "stream_handle": lambda: build.stream_handle(b0),
        "entry_point": lambda: build.entry_point(name),
        "check_cuda_matrix": lambda: build.check_cuda_matrix(b0, name),
    }
    if hasattr(DI, "device_split_plan"):
        plan = DI.device_split_plan(b0)
        out = torch.empty(n * n + plan.mid_floats, device=b0.device)
        args = (b0.data_ptr(), n, d, *plan.launch_args,
                out.data_ptr() + 4 * n * n, out.data_ptr(),
                build.stream_handle(b0))
        calls["plan"] = lambda: DI.device_split_plan(b0)
        calls["C entry point"] = lambda: fn(*args)
    else:
        plan = DI.device_gram_plan(b0)
        ws = DI.gram_workspace(b0, plan)
        args = (b0.data_ptr(), n, d, *plan.launch_args, ws.data_ptr(),
                build.stream_handle(b0))
        calls["plan"] = lambda: DI.device_gram_plan(b0)
        calls["C entry point"] = lambda: fn(*args)
    for what, call in calls.items():
        print(f"[host] {label} {what:20s} {host_us(call):.1f} us",
              flush=True)


def phase21(root, label):
    """ROOT's own chip_smoke.py phase 21 (a)."""
    import torch

    build, _ = load(root)
    cs = importlib.import_module("chip_smoke")
    assert Path(cs.__file__).resolve().parent == Path(root).resolve()
    torch.backends.cuda.matmul.allow_tf32 = False
    failures = []
    cs.p21_kernels(cs.peaks_for(torch.cuda.get_device_name(0))[1],
                   failures, cs.smi_line())
    print(f"[ab] {label} phase 21 (a) failures={failures}", flush=True)


def sweep():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    _, DI = load(".")
    print(f"[sweep] on {smi()}; cluster slots "
          f"{dict(zip(DI.CLUSTERS, DI.cluster_slots(0)))}", flush=True)
    for n, d, dt in ((100, 39_755, "float32"), (100, 39_755, "bfloat16"),
                     (100, 5_460, "float32")):
        dtype = getattr(torch, dt)
        G = torch.from_numpy(cohort(n, d, 24, 2)).cuda().to(dtype)
        bf16 = dtype == torch.bfloat16
        picked = DI.device_split_plan(G)
        want = DI.gram_partials_plain(G)
        plans = [picked]
        for chain in DI.SPLIT_CHAINS:
            if bf16 and chain < picked.stage_k:
                continue
            total = -(-d // chain)
            for cluster in (1, 2, 8, 16):
                for slices in (32, 48, 64, 86, 96, 128, 132, 256):
                    slices -= slices % cluster
                    if 0 < slices <= total:
                        plans.append(picked._replace(
                            chain=chain, chains=total, cluster=cluster,
                            slices=slices, cps=-(-total // slices)))
        for plan in plans:
            got = DI.gram_partials(G, plan=plan).ws
            err = float((got - want).abs().max() / want.abs().max())
            us, names = device_us(lambda: DI.gram_partials(G, plan=plan))
            tag = "picked" if plan is picked else "forced"
            print(f"[sweep] ({n}, {d:,}) {dt} {tag} chain={plan.chain} "
                  f"cluster={plan.cluster} slices={plan.slices} "
                  f"cps={plan.cps} runs={plan.runs} us="
                  f"{'not measured' if us is None else f'{us:.1f}'} "
                  f"rel={err:.2e} kernels={names}", flush=True)


def sass(root_a, root_b):
    """Compare the fused kernels' SASS of two trees."""
    dumps = []
    for root in (root_a, root_b):
        out = subprocess.run(
            [sys.executable, "-c",
             "import sys; sys.path.insert(0, sys.argv[1]); "
             "from attacking_federate_learning_tpu_torch.ops import _build; "
             "_build.build_all(['pairwise_distances', 'krum_scores']); "
             "print(_build.library_path('pairwise_distances')); "
             "print(_build.library_path('krum_scores'))", str(root)],
            capture_output=True, text=True, check=True, cwd=root)
        libs = out.stdout.split()
        funcs = {}
        for lib in libs:
            text = subprocess.run(["cuobjdump", "-sass", lib],
                                  capture_output=True, text=True,
                                  check=True).stdout
            for block in text.split("Function : ")[1:]:
                name, body = block.split("\n", 1)
                if not re.search(r"gram_partials_kernel|gram_mma_kernelI|"
                                 r"gram_epilogue_kernel|krum", name):
                    continue
                ins = [re.sub(r"/\*[0-9a-f]{4}\*/", "", line).split(";")[0]
                       .strip() for line in body.splitlines()
                       if re.match(r"\s+/\*[0-9a-f]{4}\*/", line)]
                funcs[(Path(lib).stem.rsplit("_", 1)[0], name.strip())] = ins
        dumps.append(funcs)
    a, b = dumps
    for key in sorted(set(a) | set(b)):
        same = a.get(key) == b.get(key)
        print(f"[sass] {key[0]} {key[1][:70]} in_a={key in a} "
              f"in_b={key in b} instructions={len(a.get(key, []))}/"
              f"{len(b.get(key, []))} same={same}", flush=True)


if __name__ == "__main__":
    verb = sys.argv[1]
    if verb == "run":
        run(sys.argv[2], sys.argv[3])
    elif verb == "host":
        host(sys.argv[2], sys.argv[3])
    elif verb == "phase21":
        phase21(sys.argv[2], sys.argv[3])
    elif verb == "sweep":
        sweep()
    elif verb == "sass":
        sass(sys.argv[2], sys.argv[3])
    else:
        raise SystemExit(__doc__)
