"""Phase timers and profiler captures (the JAX package's
utils/profiling.py, in PyTorch terms).

- :class:`PhaseTimer` accumulates per-phase wall clock (``run(timer=)``'s
  'round' and 'eval'), synchronised with the card at the end of each
  phase; its summary is the run's 'profile' event.
- :func:`device_trace` is a ``torch.profiler`` capture of a block, the CPU
  activity and, on a CUDA device, the card's: it writes a Chrome trace
  under its directory (Perfetto and chrome://tracing open it) and, while
  open, arms the stage scopes (utils/costs.py), so utils/walls.py can
  book the capture onto the stage taxonomy.  ``log_dir=None`` makes it a
  no-op.  The JAX package gates its capture on a TPU relay; the port has
  none, and captures whenever it is asked.
- ``--trace-dir``'s whole-run capture (the JAX package's ``xla_trace``)
  is a :func:`device_trace` of the run.

The JAX package's ``ensure_op_profiling`` has no counterpart: no flag is
needed for the profiler to record each operation.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from collections import defaultdict
from typing import Optional

import torch

from attacking_federate_learning_tpu_torch.utils import costs


def synchronize(target) -> None:
    """Wait for the card that holds ``target`` (a tensor, or a tuple or
    list of them); nothing to wait for on the CPU."""
    if isinstance(target, (tuple, list)):
        for t in target:
            synchronize(t)
        return
    if isinstance(target, torch.Tensor) and target.is_cuda:
        torch.cuda.synchronize(target.device)


class PhaseTimer:
    """Accumulates per-phase wall clock, synchronised with the card."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync_on=None):
        """``sync_on``: a tensor (or a zero-argument callable returning
        one, evaluated after the block so it can name what the block
        produced) to synchronise on before the clock stops.  The phase is
        accounted even when the block or the sync raises."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            try:
                if sync_on is not None:
                    synchronize(sync_on() if callable(sync_on) else sync_on)
            finally:
                dt = time.perf_counter() - t0
                self.totals[name] += dt
                self.counts[name] += 1

    def summary(self) -> dict:
        return {name: {"total_s": round(self.totals[name], 4),
                       "count": self.counts[name],
                       "mean_ms": round(1e3 * self.totals[name]
                                        / max(self.counts[name], 1), 3)}
                for name in self.totals}


def _wants_cuda(device) -> bool:
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


class _Capture:
    """One open ``torch.profiler`` session of :func:`device_trace`,
    written as ``<log_dir>/<host>.trace.json`` (its k-th later segment
    as ``<host>.<k>.trace.json``)."""

    def __init__(self, log_dir: str, cuda: bool):
        self.log_dir, self.cuda = log_dir, cuda
        self.segments = 0
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.cuda:
            activities.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=activities)
        self.prof.start()

    def stop(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        prof, self.prof = self.prof, None
        prof.stop()
        host = socket.gethostname()
        name = (f"{host}.trace.json" if self.segments == 0
                else f"{host}.{self.segments}.trace.json")
        self.segments += 1
        prof.export_chrome_trace(os.path.join(self.log_dir, name))


# The captures open now, outermost first; only the innermost records.
_OPEN: list = []


@contextlib.contextmanager
def device_trace(log_dir: Optional[str], device=None):
    """Capture the block with ``torch.profiler`` (CPU activity, and CUDA
    activity when ``device`` is a CUDA device, or when it is None and a
    card is present) into ``<log_dir>/<host>.trace.json``, the stage
    scopes armed; a no-op when ``log_dir`` is None.  The card is
    synchronised before the capture stops, so every kernel launched in
    the block is in it.

    Profiler sessions cannot nest: a capture opened inside another
    (``--profile-every``'s intervals inside ``--trace-dir``'s whole run)
    pauses the outer one, which goes on after it in a new file of its
    directory, ``<host>.<k>.trace.json``."""
    if not log_dir:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    cap = _Capture(log_dir, _wants_cuda(device))
    outer = _OPEN[-1] if _OPEN else None
    if outer is not None:
        outer.stop()
    _OPEN.append(cap)
    try:
        with costs.capturing():
            cap.start()
            try:
                yield
            finally:
                cap.stop()
    finally:
        _OPEN.pop()
        if outer is not None:
            outer.start()

