"""Threefry-2x32 random bits on the device, and the draws built on them.

:func:`threefry_bits` — ``(K, 2)`` key words -> ``(K, n)`` bits, element
``(k, i)`` the uint32 ``y0 ^ y1`` of ``threefry2x32(key_k, (0, i))``
held in an int64 (csrc/threefry_bits.cu): the bits of
``jax.random.bits(key_k, (n,))``, which utils/threefry.py draws on the
host.  No TPU kernel has this role: the JAX package draws DnC's sketch
with XLA's threefry inside its jitted round, and the port draws it on
the card, where a host draw would take longer than the round.

On top of it, the ``jax.random`` draws DnC needs, bit for bit the host
versions in utils/threefry.py (the keys are split on the host, which is
cheap; the bits and everything after them stay on ``device``):

- :func:`permutations` — ``jax.random.permutation(k, n)`` for K keys:
  JAX's ``_shuffle`` rounds, each a stable sort of the indices on 32
  fresh bits an element;
- :func:`normals` — ``jax.random.normal(k, (r,))`` for K keys: the
  uniform on ``[nextafter(-1, 0), 1)`` bit for bit, then ``sqrt(2)
  erfinv(u)`` with the device's erfinv (the last bits may differ from
  XLA's polynomial and from the CPU's).

The wrapper launches the kernel for keys on a CUDA device and takes the
plain PyTorch version (:func:`threefry_bits_plain`, int64 arithmetic
masked to 32 bits) for keys on the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from attacking_federate_learning_tpu_torch.ops import _build
from attacking_federate_learning_tpu_torch.utils import threefry
from attacking_federate_learning_tpu_torch.utils.costs import (
    KernelCost, counted_kernel
)

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry_bits_plain(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(K, 2) int64 key words -> (K, n) int64 bits in plain PyTorch, on
    the keys' device: utils/threefry.py's threefry2x32 of the counters
    ``(0, i)`` with every word kept below 2**32 by a mask."""
    k0, k1 = keys[:, 0:1], keys[:, 1:2]
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = k0.expand(keys.shape[0], n)
    x1 = (torch.arange(n, dtype=torch.int64, device=keys.device)[None, :]
          + k1) & _MASK
    for s in range(5):
        for r in _ROTATIONS[s % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) & _MASK) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(s + 1) % 3]) & _MASK
        x1 = (x1 + ks[(s + 2) % 3] + (s + 1)) & _MASK
    return x0 ^ x1


def threefry_bits_cost(K: int, n: int) -> KernelCost:
    """The kernel's work for K keys of n bits: about 80 integer
    operations an element (bounded at the fp32 rate: the card retires
    32-bit adds, shifts and xors on the same units), the int64 output
    written and the 16-byte keys read."""
    return KernelCost(80 * K * n, 8 * K * n + 16 * K)


@counted_kernel("threefry_bits",
                lambda keys, n: threefry_bits_cost(keys.shape[0], n))
def threefry_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(K, 2) int64 key words (each < 2**32) -> (K, n) int64 bits, n <
    2**32."""
    if keys.device.type == "cpu":
        return threefry_bits_plain(keys, n)
    name = "threefry_bits"
    if (keys.dtype != torch.int64 or keys.dim() != 2 or keys.shape[1] != 2
            or not keys.is_contiguous()):
        raise ValueError(f"{name}: expected contiguous (K, 2) int64 keys, "
                         f"got {keys.dtype} {tuple(keys.shape)}")
    if not 0 <= n < 2 ** 32:
        raise ValueError(f"{name}: n = {n} does not fit the 32-bit counter")
    fn = _build.entry_point(name)
    out = torch.empty((keys.shape[0], n), dtype=torch.int64,
                      device=keys.device)
    status = fn(keys.data_ptr(), keys.shape[0], n, out.data_ptr(),
                _build.stream_handle(keys))
    _build.check_status(name, status)
    _build.LAUNCHES[name] += 1
    return out


def _key_words(keys, device) -> torch.Tensor:
    """(K, 2) uint32 host keys as the int64 words the kernel reads, one
    small copy to ``device`` (pinned on the card, so the host does not
    wait for the stream's earlier kernels)."""
    words = torch.from_numpy(np.asarray(keys, np.uint32).astype(
        np.int64)).reshape(-1, 2)
    if torch.device(device).type == "cuda":
        words = words.pin_memory()
    return words.to(device, non_blocking=True)


def shuffle_rounds(n: int) -> int:
    """JAX's ``_shuffle`` round count: ceil(3 ln n / ln(2**32 - 1))."""
    return int(math.ceil(3 * math.log(max(1, n))
                         / math.log(np.iinfo(np.uint32).max)))


def split_keys(keys) -> np.ndarray:
    """``jax.random.split(k)`` of each of the K host keys ((K, 2)
    uint32) in one vectorized threefry call: (K, 2, 2), row k holding
    split(key_k)."""
    keys = np.asarray(keys, np.uint32).reshape(-1, 2)
    K = len(keys)
    y0, y1 = threefry.threefry2x32(
        (keys[:, 0:1], keys[:, 1:2]), np.zeros((K, 2), np.uint32),
        np.broadcast_to(np.arange(2, dtype=np.uint32), (K, 2)))
    return np.stack([y0, y1], axis=-1)


def permutations(keys, n: int, device) -> torch.Tensor:
    """``jax.random.permutation(k, n)`` for each of the K host keys
    ``keys`` ((K, 2) uint32), as a (K, n) int64 tensor on ``device``: every
    round's bits in one launch, then one stable sort a round."""
    keys = np.asarray(keys, np.uint32).reshape(-1, 2)
    rounds = shuffle_rounds(n)
    subs, cur = [], keys
    for _ in range(rounds):
        pair = split_keys(cur)
        cur = pair[:, 0]
        subs.append(pair[:, 1])
    K = len(keys)
    x = torch.arange(n, dtype=torch.int64, device=device).expand(K, n)
    if rounds == 0:
        return x.clone()
    # Key-major rows, as the bits view below reads them.
    subs = np.stack(subs, axis=1)
    bits = threefry_bits(_key_words(subs, device), n).view(K, rounds, n)
    for r in range(rounds):
        order = torch.sort(bits[:, r], dim=1, stable=True).indices
        x = torch.gather(x, 1, order)
    return x


def normals(keys, r: int, device) -> torch.Tensor:
    """``jax.random.normal(k, (r,))`` (float32) for each of the K host
    keys, as a (K, r) tensor on ``device``."""
    keys = np.asarray(keys, np.uint32).reshape(-1, 2)
    bits = threefry_bits(_key_words(keys, device), r)
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(-1.0).nextafter(torch.tensor(0.0)).item()
    u = torch.clamp(u * (1.0 - lo) + lo, min=lo)
    return math.sqrt(2) * torch.erfinv(u)
