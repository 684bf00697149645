"""Host-resident streaming of the round batches, the JAX package's
``data/stream.py`` for ``cfg.data_placement='host_stream'``: the training
arrays stay in host memory, each round's (m, k B) batch is gathered on the
host and copied to the card ahead of the round that reads it:

    xs, ys = stream.get(t)     # round t's batch, on the device; then
                               # the gathers of t+1..t+prefetch start

On the card, each round's gather is written straight into a pinned staging
buffer (``np.take`` with ``out=``: a copy from pageable memory would not be
asynchronous) and copied with ``non_blocking=True`` on a CUDA stream of
the stream's own; an event recorded after the copy is what the compute
stream waits on in :meth:`HostStream.get`.  Lifetimes:

- a staging buffer returns to the pool as soon as its copy is issued, and
  is written again only after that copy's event has completed;
- the device tensors are made on the copy stream and read on the compute
  stream, so :meth:`get` marks them used there (``record_stream``) before
  the caching allocator may hand their memory out again.

``workers=1`` runs the gather and the copy on one worker thread (on the
stream's device), so the host gather overlaps the card's
work; a worker's exception reaches :meth:`get` through its future.  The
copies belong to the deliver stage: a get runs inside ``compute_grads``'
scope, and under a profiler capture the worker opens deliver's range.
``prefetch`` rounds stay in flight, none past ``n_rounds``; after a jump
(a resume) the slots of other rounds are dropped and their futures
cancelled.  The round batches are the device path's bit for bit
(data/partition.py:round_batch_indices, cycling each shard), and the
cohort of round t comes from ``participants_fn(t)``, a pure function of
the round (core/population.py:legacy_cohort), so a prefetched round draws
exactly the cohort the round uses and no host generator moves.

On the CPU (the tests) the same gathers become CPU tensors, with no
staging and no copy: the plain version.

With a mesh ``plan`` (parallel/mesh.py) each position's rows of the
staged batch (``MeshPlan.row_bounds``) land on that position, each in a
buffer of its own, and :meth:`HostStream.get` returns ``(xs, ys)`` as
tuples of the positions' blocks, in position order.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from attacking_federate_learning_tpu_torch.utils import costs


class HostStream:
    def __init__(self, train_x, train_y, shards, batch_size: int, device,
                 n_rounds=None, participants_fn=None, prefetch: int = 1,
                 workers: int = 0, plan=None):
        self.x = np.ascontiguousarray(train_x)
        self.y = np.ascontiguousarray(train_y, dtype=np.int64)
        self.shards = np.asarray(shards)
        self.batch_size = int(batch_size)
        self.device = torch.device(device)
        # Prefetch horizon: nothing gathered past the last round (None:
        # unbounded).
        self.n_rounds = n_rounds
        self.participants_fn = participants_fn
        self.plan = plan
        self.prefetch = max(int(prefetch), 1)
        self._x_dtype = torch.from_numpy(self.x[:0]).dtype
        self._cuda = self.device.type == "cuda"
        self._pool = None
        if workers:
            # One worker keeps issue order = round order.
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(max_workers=1)
        self._cache: dict = {}
        # Free pinned (x, y, event) staging buffers; one thread produces
        # (the caller's, or the one worker's), so no lock.
        self._staging: list = []
        self._stream = None               # the copy stream, made lazily
        # Stall accounting: host wall time get() spends waiting for a
        # gather and its copy instead of overlapping the card's work.
        self.stall_s = 0.0
        self.cold_misses = 0
        self.gets = 0

    # ------------------------------------------------------------------
    def indices(self, t: int) -> np.ndarray:
        """Round t's (m, B) rows of the training arrays."""
        shard_len = self.shards.shape[1]
        offs = (t * self.batch_size
                + np.arange(self.batch_size)) % shard_len
        shards = self.shards
        if self.participants_fn is not None:
            part = self.participants_fn(t)
            if part is not None:
                shards = shards[np.asarray(part)]
        return shards[:, offs]

    def _buffers(self, shape_x, shape_y):
        """A pinned staging pair of these shapes whose last copy has
        finished: a free one, else a new one while fewer than prefetch + 1
        exist, else the oldest, once its copy is done."""
        same = [i for i, (bx, by, _) in enumerate(self._staging)
                if bx.shape == shape_x and by.shape == shape_y]
        ready = [i for i in same if self._staging[i][2].query()]
        if ready or len(same) > self.prefetch:
            bx, by, ev = self._staging.pop((ready or same)[0])
            ev.synchronize()              # its copy has read it
            return bx, by
        return (torch.empty(shape_x, dtype=self._x_dtype, pin_memory=True),
                torch.empty(shape_y, dtype=torch.int64, pin_memory=True))

    def _blocks(self, n: int):
        """The row blocks the batch goes out in: one (all of it, to the
        stream's device), or each mesh position's rows to its device."""
        if self.plan is None:
            return [(0, n, self.device)]
        return [(lo, hi, dev) for (lo, hi), dev in
                zip(self.plan.row_bounds(n), self.plan.positions)]

    def _produce(self, t: int):
        idx = self.indices(t)
        blocks = self._blocks(idx.shape[0])
        if not self._cuda:
            x = np.take(self.x, idx, axis=0)
            y = np.take(self.y, idx, axis=0)
            if self.plan is None:
                return torch.from_numpy(x), torch.from_numpy(y)
            return (tuple(torch.from_numpy(x[lo:hi].copy())
                          for lo, hi, _ in blocks),
                    tuple(torch.from_numpy(y[lo:hi].copy())
                          for lo, hi, _ in blocks))
        with torch.cuda.device(self.device), self._deliver_range():
            bx, by = self._buffers(idx.shape + self.x.shape[1:], idx.shape)
            np.take(self.x, idx, axis=0, out=bx.numpy(), mode="clip")
            np.take(self.y, idx, axis=0, out=by.numpy(), mode="clip")
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self._stream):
                xs = tuple(bx[lo:hi].to(dev, non_blocking=True)
                           for lo, hi, dev in blocks)
                ys = tuple(by[lo:hi].to(dev, non_blocking=True)
                           for lo, hi, dev in blocks)
                done = torch.cuda.Event()
                done.record(self._stream)
            self._staging.append((bx, by, done))
        if self.plan is None:
            xs, ys = xs[0], ys[0]
        return xs, ys, done

    def _deliver_range(self):
        """Under a profiler capture, the worker thread's copies open the
        deliver stage's range, so utils/walls.py books them there (the
        caller's own gets run inside compute_grads' deliver scope)."""
        if self._pool is None or not costs.capturing_now():
            return contextlib.nullcontext()
        return torch.profiler.record_function("deliver")

    def _issue(self, t: int):
        if t in self._cache:
            return
        self._cache[t] = (self._pool.submit(self._produce, t)
                          if self._pool is not None else self._produce(t))

    def get(self, t: int):
        """Round t's (xs, ys) on the device, ready for the compute
        stream; then starts rounds t+1..t+prefetch within the horizon."""
        t = int(t)
        self.gets += 1
        t0 = time.perf_counter()
        if t not in self._cache:
            self.cold_misses += 1
        self._issue(t)                    # a hit if prefetched
        out = self._cache.pop(t)
        # Drop the slots of other rounds (after a jump); a queued stale
        # gather would delay the next round's on the one worker.
        stale = [v for k, v in self._cache.items()
                 if not t < k <= t + self.prefetch]
        self._cache = {k: v for k, v in self._cache.items()
                       if t < k <= t + self.prefetch}
        if self._pool is not None:
            for fut in stale:
                fut.cancel()
        for u in range(t + 1, t + 1 + self.prefetch):
            if self.n_rounds is None or u < self.n_rounds:
                self._issue(u)            # overlaps round t's work
        if self._pool is not None:
            out = out.result()            # a worker's error raises here
        if self._cuda:
            xs, ys, done = out
            for a in ((xs, ys) if self.plan is None else xs + ys):
                compute = torch.cuda.current_stream(a.device)
                compute.wait_event(done)
                a.record_stream(compute)
            out = (xs, ys)
        self.stall_s += time.perf_counter() - t0
        return out

    def stall_stats(self) -> dict:
        """The run's stall record (a 'stream' event), the JAX package's
        fields."""
        return {"stream_stall_s": round(self.stall_s, 4),
                "stream_gets": self.gets,
                "stream_cold_misses": self.cold_misses,
                "stream_stall_per_get_ms": round(
                    1e3 * self.stall_s / max(self.gets, 1), 3)}

    def close(self) -> None:
        """Stop the worker (what it runs is finished first)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
