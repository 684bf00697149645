"""Build and load the port's hand-written CUDA kernels.

Each source in ``csrc/`` is compiled by ``nvcc`` for Hopper (sm_90a) into
its own shared library with a plain C interface, loaded with ``ctypes``;
what nvcc printed is kept beside it (:func:`ptxas_log`).  A source may
hold more than one kernel's entry point: the distance and Krum sources
hold their bf16 operand routes too (``pairwise_distances[bf16]`` and
``krum_scores[bf16]``, each with its own launch counter).  The two routes
share the Gram's epilogue (csrc/gram_tile.cuh) and differ in stage 1:
the f32 route's runs on the FMA units (gram_tile.cuh, plan
:func:`~.distances.gram_plan`), bound by operations at 67 TFLOP/s; the
bf16 route's on the tensor cores with wgmma (csrc/gram_mma.cuh, plan
:func:`~.distances.mma_plan`), bound by bytes up to about n = 150 and
by operations at 989 TFLOP/s above.
``threefry_bits`` (csrc/threefry_bits.cu) ports no TPU kernel: it draws
DnC's sketch bits on the card (ops/threefry_bits.py); nor do
``secagg_deltas``, ``secagg_residue`` and ``secagg_unmask_sum``
(csrc/secagg_masks.cu), secure aggregation's masks (ops/secagg_masks.py).
No PyTorch header is compiled, so a build takes seconds.  The libraries
go into ``_build/`` beside this package (listed in ``.gitignore``), named
by a hash of the sources and flags, so an edited source is rebuilt and a
checkout builds from its own sources at first use.  :func:`build_all`
starts one ``nvcc`` per missing library, all at once.
:func:`set_build_dir` names another build directory: a campaign points its
cells' builds at its own (campaigns/scheduler.py), in process or, through
``$FL_TORCH_BUILD_DIR`` (:data:`BUILD_DIR_ENV`, read by cli.py), in its
supervised children.

The host engines' C++ (``native/bulyan_select.cpp``: the exact Bulyan
selection and the column-blocked trimmed mean and median) takes a g++
route beside nvcc: :func:`build_host_library` compiles it with ``g++ -O3
-std=c++17 -shared -fPIC`` into ``_build/`` at first use, named by a hash
of the source and flags the same way, and :func:`load_host_library`
loads it.  It builds on any machine with g++, the card's or not, and a
failed build or load raises: nothing falls back to another route.

Nothing here runs at import: the CPU tests import every module, and a
CPU-only machine has no ``nvcc``.  Each wrapper counts its launches in
:data:`LAUNCHES`, so a caller can show which kernels a run went through.
:data:`COMPILES` keeps each library's build facts for the cost report's
'compile' events (utils/costs.py): the seconds :func:`build_all` took
for it, and whether it was already under ``_build/`` ('hit') or nvcc ran
('miss').  :data:`CACHE_COUNTS` counts every resolution of a library,
the host libraries' included, since the process started: a hit where it
was found in the build directory, a miss where a compiler ran; both
records are kept by one helper, :func:`_note_compile`.
:func:`forget_loaded` makes the next launch of each kernel resolve its
library again.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

from attacking_federate_learning_tpu_torch.utils import costs

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
# The variable that gives a CLI run another build directory (cli.py).
BUILD_DIR_ENV = "FL_TORCH_BUILD_DIR"
# Another build directory than BUILD_DIR, when set (set_build_dir).
_BUILD_DIR_OVERRIDE: Optional[Path] = None

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# (G, n, d, [comp,] slices, cps, kgroups or the bf16 route's stage_k, ws,
# D, [scores, rowsums,] stream)
_GRAM_ARGS = (_P, _I, _LL, _I, _I, _I, _P, _P, _P)
_KRUM_ARGS = (_P, _I, _LL, _I, _I, _I, _I, _P, _P, _P, _P, _P)

# kernel name -> (source in csrc/, C entry point, its argument types).
# Every entry point takes the stream last and returns a cudaError_t.
KERNELS = {
    "pairwise_distances": ("pairwise_distances.cu", "fl_pairwise_distances",
                           _GRAM_ARGS),
    "pairwise_distances[bf16]": ("pairwise_distances.cu",
                                 "fl_pairwise_distances_bf16", _GRAM_ARGS),
    "krum_scores": ("krum_scores.cu", "fl_krum_scores", _KRUM_ARGS),
    "krum_scores[bf16]": ("krum_scores.cu", "fl_krum_scores_bf16",
                          _KRUM_ARGS),
    # The distance kernel's two stages apart, for the model axis' split
    # Gram (ops/distances.py: gram_partials, gram_epilogue), and the Krum
    # kernel's per-row selection on a given D (krum_rows).
    # (G, n, d, slices, chain, cluster, kgroups or stage_k, mid, gram,
    # stream); the epilogue (grams, m, n, D, stream), grams a host array
    # of the m Grams' device pointers.
    "gram_partials": ("pairwise_distances.cu", "fl_gram_partials",
                      (_P, _I, _LL, _I, _I, _I, _I, _P, _P, _P)),
    "gram_partials[bf16]": ("pairwise_distances.cu",
                            "fl_gram_partials_bf16",
                            (_P, _I, _LL, _I, _I, _I, _I, _P, _P, _P)),
    "gram_epilogue": ("pairwise_distances.cu", "fl_gram_epilogue",
                      (_P, _I, _I, _P, _P)),
    "krum_rows": ("krum_scores.cu", "fl_krum_rows",
                  (_P, _I, _I, _P, _P, _P)),
    "trimmed_mean": ("trimmed_mean.cu", "fl_trimmed_mean",
                     (_P, _I, _LL, _I, _I, _P, _P)),
    "median": ("median.cu", "fl_median", (_P, _I, _LL, _I, _P, _P)),
    "masked_trimmed_mean": ("masked_trimmed_mean.cu",
                            "fl_masked_trimmed_mean",
                            (_P, _P, _P, _I, _LL, _I, _I, _I, _P, _P)),
    "masked_median": ("masked_median.cu", "fl_masked_median",
                      (_P, _P, _P, _I, _LL, _I, _I, _P, _P)),
    # No TPU kernel's port: DnC's sketch bits (ops/threefry_bits.py).
    "threefry_bits": ("threefry_bits.cu", "fl_threefry_bits",
                      (_P, _I, _LL, _P, _P)),
    # No TPU kernel's port: secure aggregation's masks
    # (ops/secagg_masks.py), three entry points of one source.
    "secagg_deltas": ("secagg_masks.cu", "fl_secagg_deltas",
                      (_P, _P, _I, _LL, _I, _I, _P, _P)),
    "secagg_residue": ("secagg_masks.cu", "fl_secagg_residue",
                       (_P, _P, _P, _I, _LL, _P, _P, _P)),
    "secagg_unmask_sum": ("secagg_masks.cu", "fl_secagg_unmask_sum",
                          (_P, _P, _P, _P, _I, _LL, _P, _P, _P)),
}
# -Xptxas -v: each kernel's registers, stack frame and spills, kept in
# the build's log (ptxas_log).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Launches per kernel since the last reset: each wrapper adds one where it
# launches its kernel, and nowhere else.
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

# Library (its source's stem) -> {'compile_s': s, 'cache': 'hit' |
# 'miss'}, the first build or load of each in this process.
COMPILES: Dict[str, dict] = {}

# Library resolutions since the process started: a 'hit' found the library
# in the build directory, a 'miss' ran a compiler for it.
CACHE_COUNTS: Dict[str, int] = {"hit": 0, "miss": 0}

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()

# Host libraries (C++ for the CPU, g++): name -> source in the package.
HOST_LIBS = {"bulyan_select": "native/bulyan_select.cpp"}
GXX = "g++"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def _note_compile(name: str, compile_s: float, cache: str) -> None:
    """One resolution of kernel ``name``'s library, or of host library
    ``name``: 'hit' or 'miss', counted in CACHE_COUNTS.  A kernel's
    library keeps its first resolution in COMPILES."""
    CACHE_COUNTS[cache] += 1
    if name in KERNELS:
        COMPILES.setdefault(Path(KERNELS[name][0]).stem,
                            {"compile_s": compile_s, "cache": cache})


def build_dir() -> Path:
    """Where the libraries are built: the directory set_build_dir named,
    else BUILD_DIR."""
    return _BUILD_DIR_OVERRIDE or BUILD_DIR


def set_build_dir(path) -> Optional[Path]:
    """Build and load the libraries in ``path`` from now on (None: in
    BUILD_DIR); returns the directory set before."""
    global _BUILD_DIR_OVERRIDE
    old = _BUILD_DIR_OVERRIDE
    _BUILD_DIR_OVERRIDE = None if path is None else Path(path)
    return old


def forget_loaded() -> None:
    """Drop the loaded libraries, so each kernel's next launch resolves
    its library from the build directory again (a hit, or a miss that
    builds it)."""
    with _LOCK:
        _LOADED.clear()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc_path() -> Optional[str]:
    """The CUDA compiler: $NVCC, else nvcc on PATH, else the toolkit's
    default install location; None when there is none."""
    env = os.environ.get("NVCC")
    if env:
        return env if os.path.exists(env) else None
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    return default if os.path.exists(default) else None


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library lives (one per source), keyed by a
    hash of its source, the shared headers and the compiler flags."""
    source = CSRC / KERNELS[name][0]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [source] + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return build_dir() / f"{source.stem}_{h.hexdigest()[:16]}.so"


def ptxas_log(name: str) -> str:
    """What nvcc printed when it built kernel ``name``'s library (ptxas's
    register, stack and spill report among it); empty if it is not
    built."""
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every missing library of the kernels ``names`` (default:
    all), one ``nvcc`` process per source, started together.  Returns the
    seconds each source's build took (0.0 for one already built); raises
    RuntimeError with the compiler's output if a build fails or there is
    no ``nvcc``."""
    names = list(KERNELS if names is None else names)
    # One build per source, named by its first kernel.
    todo = {}
    for n in names:
        out = library_path(n)
        if out.exists():
            _note_compile(n, 0.0, "hit")
        elif out not in todo.values():
            todo[n] = out
    times = {KERNELS[n][0]: 0.0 for n in names}
    if not todo:
        return times
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError(
            f"cannot build CUDA kernels {sorted(todo)}: no nvcc found "
            f"(set $NVCC or put the CUDA toolkit's bin on PATH)")
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        tmp = out.with_suffix(f".so.tmp.{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[KERNELS[name][0]] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc {KERNELS[name][0]} failed "
                          f"(rc {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
            _note_compile(name, times[KERNELS[name][0]], "miss")
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def host_library_path(name: str) -> Path:
    """Where host library ``name`` lives, keyed by a hash of its source
    and the compiler flags."""
    source = PACKAGE_DIR / HOST_LIBS[name]
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(source.name.encode())
    h.update(source.read_bytes())
    return build_dir() / f"{source.stem}_{h.hexdigest()[:16]}.so"


def build_host_library(name: str) -> Path:
    """Compile host library ``name`` with g++ (:data:`GXX`) unless it is
    built; returns its path.  Raises RuntimeError with the compiler's
    output if the build fails or there is no compiler."""
    out = host_library_path(name)
    if out.exists():
        _note_compile(name, 0.0, "hit")
        return out
    gxx = shutil.which(GXX)
    if gxx is None:
        raise RuntimeError(
            f"cannot build host library {name!r}: no C++ compiler at "
            f"{GXX!r}")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".so.tmp.{os.getpid()}")
    proc = subprocess.run(
        [gxx, *GXX_FLAGS, "-o", str(tmp), str(PACKAGE_DIR / HOST_LIBS[name])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ {HOST_LIBS[name]} failed "
                           f"(rc {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)             # atomic: concurrent builders race
    _note_compile(name, 0.0, "miss")
    return out


def load_host_library(name: str) -> ctypes.CDLL:
    """Host library ``name``, built (:func:`build_host_library`) and
    loaded once a process."""
    key = "host:" + name
    with _LOCK:
        lib = _LOADED.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build_host_library(name)))
            _LOADED[key] = lib
    return lib


def library(name: str) -> ctypes.CDLL:
    """Kernel ``name``'s library, built and loaded first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            path = library_path(name)
            if path.exists():
                _note_compile(name, 0.0, "hit")
            else:
                build_all([name])
            lib = ctypes.CDLL(str(path))
            _LOADED[name] = lib
    return lib


def entry_point(name: str):
    """Kernel ``name``'s C entry point with its argument types declared,
    building and loading the library first if needed; under a profiler
    capture each call is a ``record_function`` range named by the entry
    point."""
    lib = library(name)
    _, symbol, argtypes = KERNELS[name]
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int

    def launch(*args):
        # Under a profiler capture the C call is a range named by its
        # entry point: utils/walls.py files the device events it
        # launches under that name, and nothing else the wrapper runs.
        if not costs.capturing_now():
            return fn(*args)
        with torch.profiler.record_function(symbol):
            return fn(*args)
    return launch


def check_status(name: str, status: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError_t {status})")


def check_cuda_matrix(G, name: str) -> None:
    """What every kernel takes: a contiguous 2-D CUDA tensor, float32, or
    bfloat16 for the bf16 routes (``[bf16]`` in the name)."""
    if G.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel takes a CUDA tensor, "
                         f"got one on {G.device}")
    want = torch.bfloat16 if name.endswith("[bf16]") else torch.float32
    if G.dtype != want or G.dim() != 2 or not G.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous 2-D "
                         f"{str(want)[len('torch.'):]} tensor, got {G.dtype} "
                         f"{tuple(G.shape)} contiguous={G.is_contiguous()}")
    if G.shape[0] < 1 or G.shape[1] < 1:
        raise ValueError(f"{name}: empty matrix {tuple(G.shape)}")


def check_cuda_rows(G, mask, weights, name: str) -> None:
    """What the masked kernels take beside the matrix: an (n,) bool mask
    and, if given, (n,) float32 weights, contiguous, on G's device."""
    n = G.shape[0]
    if (mask.device != G.device or mask.dtype != torch.bool
            or tuple(mask.shape) != (n,) or not mask.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous ({n},) bool mask "
                         f"on {G.device}, got {mask.dtype} "
                         f"{tuple(mask.shape)} on {mask.device}")
    if weights is not None and (
            weights.device != G.device or weights.dtype != torch.float32
            or tuple(weights.shape) != (n,) or not weights.is_contiguous()):
        raise ValueError(f"{name}: expected contiguous ({n},) float32 "
                         f"weights on {G.device}, got {weights.dtype} "
                         f"{tuple(weights.shape)} on {weights.device}")


def stream_handle(G) -> int:
    """PyTorch's current stream on G's device, as the raw handle."""
    return torch.cuda.current_stream(G.device).cuda_stream

