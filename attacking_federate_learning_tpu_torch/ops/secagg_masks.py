"""Secure aggregation's mask arithmetic on the device
(csrc/secagg_masks.cu), and its plain PyTorch versions.

Words are uint32 bit patterns held in int32 tensors (an f32 update's bits
through ``.view(torch.int32)``).  Three entry points, each with its own
launch counter:

- :func:`secagg_deltas` — (P, 2) pair keys (utils/threefry.py:pair_keys)
  and (n,) ids -> the (n, d) net masks: row a's word the sum over b != a
  of +m_ab where ids[a] < ids[b], else -m_ab, mod 2**32, with m_ab the
  word of ``jax.random.bits(pair_key, (d,))``;
- :func:`secagg_residue` — the (d,) net mask of the (alive i, dropped j)
  pairs, from i's side, and their count;
- :func:`secagg_unmask_sum` — the wire (clear bits plus delta), the sum
  check ``modsum(wire[alive]) - residue == modsum(clear[alive])`` ANDed
  into an int32 flag on the device, and the recovered f32 rows (dropped
  rows zeroed).

No TPU kernel has this role: the JAX package draws the masks with XLA's
threefry (its protocols/secagg.py).  Each wrapper launches its kernel for
tensors on a CUDA device and takes the plain version (int64 arithmetic
masked to 32 bits, chunked over pairs so that the card can run it at full
width for comparison) for tensors on the CPU.  :func:`deltas_plan` sizes
the deltas kernel's grid, on the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from attacking_federate_learning_tpu_torch.ops import _build
from attacking_federate_learning_tpu_torch.ops.threefry_bits import (
    threefry_bits_plain
)
from attacking_federate_learning_tpu_torch.utils.costs import (
    KernelCost, counted_kernel
)

_MASK = 0xFFFFFFFF
# csrc/secagg_masks.cu: columns a block, shared memory a block and an SM.
TILE_COLS = 256
THREADS = 128
SMEM_BLOCK = 232_448
SMEM_SM = 233_472
# Pairs a chunk of the plain versions: (chunk, d) int64 words at a time.
PLAIN_CHUNK = 64
# Integer operations of one drawn word in csrc/secagg_masks.cu, counted
# from the source: 20 rounds of add, rotate (one funnel shift) and xor
# (60), 5 key injections of 3 adds (15), the third key word (2 xors),
# the counter add, the output xor and the signed accumulate (3).  The
# card's int32 rate is a quarter of its fp32 rate: 64 int32 lanes an SM
# against 128 fp32 lanes of 2 operations.
OPS_PER_WORD = 80


def secagg_deltas_cost(n: int, d: int) -> KernelCost:
    """The deltas' work: each of the n (n - 1) / 2 pairs drawn once,
    OPS_PER_WORD a word; the (n, d) int32 masks written, the pair keys
    (8 bytes a pair) and the ids read."""
    pairs = n * (n - 1) // 2
    return KernelCost(pairs * d * OPS_PER_WORD,
                      4 * n * d + 8 * pairs + 8 * n, "int32")


def secagg_residue_cost(n: int, d: int, alive: int) -> KernelCost:
    """The residue's work: the alive x dropped pairs drawn; the (d,)
    residue written, the pair keys, ids and mask read."""
    cross = alive * (n - alive)
    return KernelCost(cross * d * OPS_PER_WORD,
                      4 * d + 8 * (n * (n - 1) // 2) + 9 * n, "int32")


def secagg_unmask_sum_cost(n: int, d: int, residue: bool,
                           alive: bool) -> KernelCost:
    """The unmask pass's bytes: the clear rows and the deltas read, the
    recovered rows written, the residue and the mask read where given."""
    return KernelCost(0, 12 * n * d + (4 * d if residue else 0)
                      + (n if alive else 0), "int32")


class DeltasPlan(NamedTuple):
    row_tile: int      # rows a block accumulates in shared memory
    splits: int        # blocks the pair range is split over, a tile
    smem: int          # shared memory a block, bytes


def deltas_plan(n: int, d: int, sms: int = 132) -> DeltasPlan:
    """The deltas kernel's grid: every row in one tile while its
    accumulators fit a block's shared memory (227 rows of 256 columns),
    and the pairs split so that the blocks fill about four waves of the
    card's ``sms`` SMs, each split at least 64 pairs."""
    row_tile = max(1, min(n, SMEM_BLOCK // (4 * TILE_COLS)))
    smem = 4 * row_tile * TILE_COLS
    blocks = math.ceil(d / TILE_COLS) * math.ceil(n / row_tile)
    per_sm = min(SMEM_SM // (smem + 1024), 2048 // THREADS, 32)
    pairs = n * (n - 1) // 2
    splits = max(1, min(math.ceil(4 * sms * per_sm / blocks),
                        pairs // 64))
    return DeltasPlan(row_tile, splits, smem)


def to_words(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the same bit patterns as int32."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def from_words(w: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their uint32 values in int64."""
    return w.to(torch.int64) & _MASK


def _signed_words(keys, sign, d):
    """(K, d) int64: each pair's words times its (K,) sign of +1 or -1."""
    return threefry_bits_plain(from_words(keys), d) * sign[:, None]


def secagg_deltas_plain(keys: torch.Tensor, ids: torch.Tensor,
                        d: int) -> torch.Tensor:
    n = ids.shape[0]
    a, b = torch.triu_indices(n, n, offset=1, device=ids.device)
    sign = torch.where(ids[a] < ids[b], 1, -1).to(torch.int64)
    acc = torch.zeros((n, d), dtype=torch.int64, device=ids.device)
    for s in range(0, a.shape[0], PLAIN_CHUNK):
        e = s + PLAIN_CHUNK
        w = _signed_words(keys[s:e], sign[s:e], d)
        acc.index_add_(0, a[s:e], w)
        acc.index_add_(0, b[s:e], -w)
        acc &= _MASK
    return to_words(acc)


def secagg_residue_plain(keys: torch.Tensor, ids: torch.Tensor,
                         alive: torch.Tensor, d: int):
    n = ids.shape[0]
    a, b = torch.triu_indices(n, n, offset=1, device=ids.device)
    cross = alive[a] != alive[b]
    a, b, keys = a[cross], b[cross], keys[cross]
    i = torch.where(alive[a], a, b)          # the alive row of each pair
    j = a + b - i
    sign = torch.where(ids[i] < ids[j], 1, -1).to(torch.int64)
    acc = torch.zeros(d, dtype=torch.int64, device=ids.device)
    for s in range(0, a.shape[0], PLAIN_CHUNK):
        e = s + PLAIN_CHUNK
        acc += _signed_words(keys[s:e], sign[s:e], d).sum(0)
        acc &= _MASK
    return to_words(acc), cross.sum().to(torch.int32)


def secagg_unmask_sum_plain(clear, deltas, residue=None, alive=None,
                            ok=None):
    x = from_words(clear.view(torch.int32))
    dl = from_words(deltas)
    wire = (x + dl) & _MASK
    live = (torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
            if alive is None else alive)
    s_wire = (wire * live[:, None]).sum(0) & _MASK
    s_clear = (x * live[:, None]).sum(0) & _MASK
    res = 0 if residue is None else from_words(residue)
    good = (((s_wire - res) & _MASK) == s_clear).all().to(torch.int32)
    rec = to_words((wire - dl) & _MASK).view(torch.float32)
    rec = torch.where(live[:, None], rec, 0.0)
    if ok is None:
        ok = torch.ones((), dtype=torch.int32, device=x.device)
    ok.bitwise_and_(good)
    return rec, ok


def _check(name, t, dtype, shape, device=None):
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors on one "
                         f"device, got one on {t.device}")
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous {tuple(shape)} "
                         f"{str(dtype)[len('torch.'):]} tensor, got "
                         f"{t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")


def _check_element(name, what, t, device):
    _check(name, t, torch.int32, tuple(t.shape), device)
    if math.prod(t.shape) != 1:
        raise ValueError(f"{name}: {what} must be one int32 element")


def _check_keys_ids(name, keys, ids):
    _check(name, ids, torch.int64, (ids.shape[0],))
    n = ids.shape[0]
    _check(name, keys, torch.int32, (n * (n - 1) // 2, 2), ids.device)
    if keys.data_ptr() % 8:
        raise ValueError(f"{name}: the pair keys must be 8-byte aligned")


@counted_kernel("secagg_deltas", lambda keys, ids, d, *a, **k:
                secagg_deltas_cost(ids.shape[0], d))
def secagg_deltas(keys: torch.Tensor, ids: torch.Tensor, d: int,
                  plan: Optional[DeltasPlan] = None) -> torch.Tensor:
    """(P, 2) int32 pair keys and (n,) int64 ids -> (n, d) int32 net
    masks (uint32 patterns)."""
    if ids.device.type == "cpu":
        return secagg_deltas_plain(keys, ids, d)
    name = "secagg_deltas"
    _check_keys_ids(name, keys, ids)
    n = ids.shape[0]
    if plan is None:
        sms = torch.cuda.get_device_properties(
            ids.device).multi_processor_count
        plan = deltas_plan(n, d, sms)
    fn = _build.entry_point(name)
    out = torch.zeros((n, d), dtype=torch.int32, device=ids.device)
    status = fn(keys.data_ptr(), ids.data_ptr(), n, d, plan.row_tile,
                plan.splits, out.data_ptr(), _build.stream_handle(ids))
    _build.check_status(name, status)
    _build.LAUNCHES[name] += 1
    return out


@counted_kernel("secagg_residue", lambda keys, ids, alive, d, *a, **k:
                secagg_residue_cost(ids.shape[0], d, int(alive.sum())))
def secagg_residue(keys: torch.Tensor, ids: torch.Tensor,
                   alive: torch.Tensor, d: int, count=None):
    """The (d,) int32 residue of the (alive, dropped) pairs and their
    count, an int32 tensor (written into ``count``, an int32 element on
    the device, when given)."""
    if ids.device.type == "cpu":
        residue, pairs = secagg_residue_plain(keys, ids, alive, d)
        if count is not None:
            count.copy_(pairs)
            pairs = count
        return residue, pairs
    name = "secagg_residue"
    _check_keys_ids(name, keys, ids)
    n = ids.shape[0]
    _check(name, alive, torch.bool, (n,), ids.device)
    if count is None:
        count = torch.empty((), dtype=torch.int32, device=ids.device)
    _check_element(name, "count", count, ids.device)
    fn = _build.entry_point(name)
    residue = torch.empty(d, dtype=torch.int32, device=ids.device)
    status = fn(keys.data_ptr(), ids.data_ptr(), alive.data_ptr(), n, d,
                residue.data_ptr(), count.data_ptr(),
                _build.stream_handle(ids))
    _build.check_status(name, status)
    _build.LAUNCHES[name] += 1
    return residue, count


@counted_kernel("secagg_unmask_sum",
                lambda clear, deltas, residue=None, alive=None, *a, **k:
                secagg_unmask_sum_cost(*clear.shape, residue is not None,
                                       alive is not None))
def secagg_unmask_sum(clear: torch.Tensor, deltas: torch.Tensor,
                      residue: Optional[torch.Tensor] = None,
                      alive: Optional[torch.Tensor] = None,
                      ok: Optional[torch.Tensor] = None):
    """One pass over the (n, d) f32 ``clear`` rows and their int32
    ``deltas``: the recovered f32 rows and ``ok``, an int32 element on
    the device ANDed with the sum check (a fresh 1 when not given).
    ``residue`` None means nothing dropped; ``alive`` None every row."""
    if clear.device.type == "cpu":
        return secagg_unmask_sum_plain(clear, deltas, residue, alive, ok)
    name = "secagg_unmask_sum"
    _build.check_cuda_matrix(clear, name)
    n, d = clear.shape
    dev = clear.device
    _check(name, deltas, torch.int32, (n, d), dev)
    if residue is not None:
        _check(name, residue, torch.int32, (d,), dev)
    if alive is not None:
        _check(name, alive, torch.bool, (n,), dev)
    if ok is None:
        ok = torch.ones((), dtype=torch.int32, device=dev)
    _check_element(name, "ok", ok, dev)
    fn = _build.entry_point(name)
    recovered = torch.empty_like(clear)
    status = fn(clear.data_ptr(), deltas.data_ptr(),
                None if residue is None else residue.data_ptr(),
                None if alive is None else alive.data_ptr(), n, d,
                recovered.data_ptr(), ok.data_ptr(),
                _build.stream_handle(clear))
    _build.check_status(name, status)
    _build.LAUNCHES[name] += 1
    return recovered, ok
