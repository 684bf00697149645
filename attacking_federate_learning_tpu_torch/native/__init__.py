"""The native host engines: the port's copy of the JAX package's
``native/bulyan_select.cpp`` (the incremental exact Bulyan selection, which
makes the reference's O(n^3) sequential selection O(n^2) in all, and the
column-blocked coordinate-wise trimmed mean and median), built with g++ at
first use by ``ops/_build.py`` and called through ctypes on host numpy
arrays.

Unlike the JAX package's best-effort loader, this one has no fallback and
no switch: a failed build or load raises, and so does a call the library
refuses (its nonzero return).  The NumPy functions of ``defenses/host.py``
are the plain versions the tests hold these against; no route falls back
to them.  ctypes releases the GIL for the call.
"""

from __future__ import annotations

import ctypes

import numpy as np

from attacking_federate_learning_tpu_torch.ops import _build

_F32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_C = ctypes.c_int32

# C entry point -> its argument types (every one returns an int status).
ENTRY_POINTS = {
    "fl_bulyan_select": (_F32, _I32, _C, _C, _C, _C, _C, _C, _I32),
    "fl_trimmed_mean": (_F32, _C, _C, _C, _F32),
    "fl_median": (_F32, _C, _C, _F32),
}


def entry(symbol: str):
    """The library's C entry point ``symbol``, argument types declared;
    builds and loads the library first if needed."""
    fn = getattr(_build.load_host_library("bulyan_select"), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = list(ENTRY_POINTS[symbol])
    return fn


def _check(symbol: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"native {symbol} failed (status {rc})")


def native_bulyan_selection(D, order, users_count, corrupted_count,
                            set_size, batch_select=1, paper_scoring=False):
    """The incremental exact selection over the (n, n) distance matrix
    ``D`` (+inf diagonal) and its per-row ascending argsort ``order``:
    the (set_size,) int32 selected indices, in selection order."""
    n = D.shape[0]
    if not 0 < set_size <= n:
        raise ValueError(f"native Bulyan selection needs 0 < set_size <= n, "
                         f"got set_size={set_size}, n={n}")
    D = np.ascontiguousarray(D, np.float32)
    order = np.ascontiguousarray(order, np.int32)
    out = np.empty(set_size, np.int32)
    _check("fl_bulyan_select", entry("fl_bulyan_select")(
        D, order, n, int(users_count), int(corrupted_count), int(set_size),
        int(max(1, batch_select)), 1 if paper_scoring else 0, out))
    return out


def native_median(sel):
    """Column-blocked coordinate-wise median of the (n, d) matrix; (d,)
    f32, NumPy's midpoint of the two middle values for an even n."""
    n, d = sel.shape
    if n == 0 or d == 0:
        raise ValueError(f"native median of an empty matrix {sel.shape}")
    sel = np.ascontiguousarray(sel, np.float32)
    out = np.empty(d, np.float32)
    _check("fl_median", entry("fl_median")(sel, n, d, out))
    return out


def native_trimmed_mean(sel, number_to_consider):
    """Column-blocked median-anchored trimmed mean of the (n, d) matrix,
    keeping the ``number_to_consider`` values nearest the median (ties to
    the lowest rows); (d,) f32."""
    n, d = sel.shape
    k = int(number_to_consider)
    if not 0 < k <= n or d == 0:
        raise ValueError(f"native trimmed mean needs 0 < k <= n and d > 0, "
                         f"got k={k}, shape {sel.shape}")
    sel = np.ascontiguousarray(sel, np.float32)
    out = np.empty(d, np.float32)
    _check("fl_trimmed_mean", entry("fl_trimmed_mean")(sel, n, d, k, out))
    return out
