"""The few ``jax.random`` primitives the port's host draws need, in numpy.

The JAX package's fault schedule (``core/faults.py:fault_masks``) and its
per-round cohort (``core/population.py:legacy_cohort``) are pure
functions of ``(seed, round)`` built on ``jax.random`` with the
threefry2x32 generator in its partitionable mode
(``jax_threefry_partitionable = True``, the default of jax 0.9).  The
port draws the same bits here, on the host, so that a port run and a JAX
run of one config see the same faults and the same cohorts.  A key is a
``(2,)`` uint32 array, what ``jax.random.key_data`` returns:

- ``key(seed)``      -> ``[0, seed mod 2**32]``;
- ``fold_in(k, t)``  -> ``threefry2x32(k, [0, t])``;
- ``split(k, num)``  -> key i is ``threefry2x32(k, [0, i])``;
- ``uniform(k, (m,))`` -> element i takes the 32 bits
  ``y0 ^ y1`` of ``threefry2x32(k, [0, i])``, keeps the top 23 as the
  mantissa of a float in [1, 2) and subtracts 1;
- ``randint(k, shape, lo, hi)`` -> JAX's ``_randint`` for int32: 32
  higher and 32 lower bits from the two halves of ``split(k)``, combined
  modulo the span;
- ``bernoulli(k, p, shape)`` -> ``uniform(k, shape) < p``;
- ``permutation(k, n)`` -> JAX's ``_shuffle`` of ``arange(n)``:
  ``ceil(3 ln n / ln(2**32 - 1))`` rounds (1 up to n = 1,625, 2 from
  there to about 2.6 million), each splitting the key, drawing 32 bits
  an element and sorting stably on them;
- ``choice(k, n, size, replace=False)`` -> ``permutation(k, n)[:size]``.

``tests/test_torch_port_faults.py`` holds each against ``jax.random``
bit for bit.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 with 20 rounds (Salmon et al., SC'11) of the counter
    pairs ``(x0[i], x1[i])`` under ``key``: two uint32 arrays."""
    k = [np.uint32(key[0]), np.uint32(key[1])]
    ks = (k[0], k[1], k[0] ^ k[1] ^ _PARITY)
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def key(seed: int) -> np.ndarray:
    """``jax.random.key_data(jax.random.key(seed))`` with 64-bit types
    off: the seed's low 32 bits after a zero word."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in``: a key for ``data``, 0 <= data < 2**32."""
    data = int(data)
    if not 0 <= data < 2 ** 32:
        raise OverflowError(f"fold_in data {data} out of bounds for uint32")
    y0, y1 = threefry2x32(k, np.zeros(1, np.uint32),
                          np.array([data], np.uint32))
    return np.array([y0[0], y1[0]], np.uint32)


def pair_keys(key_t: np.ndarray, ids) -> np.ndarray:
    """Secure aggregation's pair keys: ``fold_in(fold_in(key_t, lo), hi)``
    with ``lo, hi`` the smaller and larger id of the rows a < b of
    ``ids`` (the JAX package's ``protocols/secagg.py:_pair_key``), for
    every row pair in row-major upper-triangle order ((0, 1), (0, 2),
    ..., (1, 2), ...).  ``ids`` is (n,) or a batch (..., n) of
    non-negative ids; returns (..., n (n - 1) / 2, 2) uint32.  The first
    fold is drawn once an id and gathered."""
    ids = np.asarray(ids, np.int64)
    if ids.size and (ids.min() < 0 or ids.max() >= 2 ** 32):
        raise OverflowError("pair_keys: ids must lie in [0, 2**32)")
    n = ids.shape[-1]
    a, b = np.triu_indices(n, k=1)
    ia, ib = ids[..., a], ids[..., b]
    lo_row = np.where(ia < ib, a, b)
    words = ids.astype(np.uint32)
    f0, f1 = threefry2x32(key_t, np.zeros_like(words), words)
    k0 = np.take_along_axis(f0, lo_row, axis=-1)
    k1 = np.take_along_axis(f1, lo_row, axis=-1)
    hi = np.maximum(ia, ib).astype(np.uint32)
    y0, y1 = threefry2x32((k0, k1), np.zeros_like(hi), hi)
    return np.stack([y0, y1], axis=-1)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split``: (num, 2) uint32 keys."""
    y0, y1 = threefry2x32(k, np.zeros(num, np.uint32),
                          np.arange(num, dtype=np.uint32))
    return np.stack([y0, y1], axis=1)


def random_bits(k: np.ndarray, shape) -> np.ndarray:
    """``jax.random.bits(k, shape)`` for uint32: ``y0 ^ y1`` of
    ``threefry2x32(k, [0, i])`` at each flat index i."""
    shape = tuple(shape)
    size = int(np.prod(shape, dtype=np.int64))
    y0, y1 = threefry2x32(k, np.zeros(size, np.uint32),
                          np.arange(size, dtype=np.uint32))
    return (y0 ^ y1).reshape(shape)


def uniform(k: np.ndarray, shape) -> np.ndarray:
    """``jax.random.uniform(k, shape)``: float32 in [0, 1)."""
    bits = random_bits(k, shape) >> np.uint32(9) | np.uint32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)


def randint(k: np.ndarray, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(k, shape, minval, maxval)`` (int32): the
    span's multiplier ``(2**16 mod span)**2 mod span`` and the offset
    ``(hi mod span * mult + lo mod span) mod span``, all in uint32 (so
    the product wraps as JAX's does)."""
    lo32, hi32 = np.iinfo(np.int32).min, np.iinfo(np.int32).max
    if not lo32 <= minval <= hi32 or not lo32 <= maxval <= hi32:
        raise ValueError(f"randint bounds must fit int32, got {minval}, "
                         f"{maxval}")
    k1, k2 = split(k)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = np.uint32(maxval - minval if maxval > minval else 1)
    mult = np.uint32(2 ** 16 % int(span))
    mult = np.uint32((int(mult) * int(mult)) & 0xFFFFFFFF) % span
    offset = (higher % span * mult + lower % span) % span
    return (np.int64(minval) + offset.astype(np.int64)).astype(np.int32)


def bernoulli(k: np.ndarray, p: float, shape) -> np.ndarray:
    """``jax.random.bernoulli(k, p, shape)``: a float32 uniform below
    ``p``."""
    return uniform(k, shape) < np.float32(p)


def permutation(k: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.permutation(k, n)``: ``arange(n)`` (int32) in JAX's
    shuffled order."""
    x = np.arange(n, dtype=np.int32)
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        k, sub = split(k)
        x = x[np.argsort(random_bits(sub, (n,)), kind="stable")]
    return x


def choice(k: np.ndarray, n: int, size: int,
           replace: bool = False) -> np.ndarray:
    """``jax.random.choice(k, n, (size,), replace=False)``: the first
    ``size`` of ``permutation(k, n)``.  Only sampling without
    replacement is ported."""
    if replace:
        raise NotImplementedError("choice with replacement is not ported")
    if size == 0:
        return np.zeros(0, np.int32)
    if size > n:
        raise ValueError(f"Cannot take a larger sample (size {size}) than "
                         f"population (size {n}) when 'replace=False'")
    return permutation(k, n)[:size]


def normal_bf16(k: np.ndarray, shape):
    """``jax.random.normal(k, shape, bfloat16)``, as a bf16 torch tensor:
    8 random bits an element (the low byte of ``y0 ^ y1``: JAX draws 8
    bits for a type of fewer than 8 mantissa bits), the top 7 as the
    mantissa of a bf16 in [1, 2), then JAX's steps in bf16
    arithmetic: minus 1, times ``1 - lo`` plus ``lo`` (``lo =
    nextafter(-1, 0)``), clipped at ``lo``, ``erfinv`` and times
    ``sqrt(2)``.  ``erfinv`` is torch's, computed in f32 and rounded,
    as XLA computes a bf16 op."""
    import torch

    bf = torch.bfloat16
    bits = (random_bits(k, shape) & np.uint32(0xFF)).astype(np.uint16)
    bits = (bits >> np.uint16(1)) | np.uint16(0x3F80)
    one = torch.ones((), dtype=bf)
    u = torch.from_numpy(bits.view(np.int16)).view(bf) - one
    lo = torch.tensor(-1.0, dtype=bf).nextafter(torch.tensor(0.0, dtype=bf))
    u = torch.maximum(lo, u * (one - lo) + lo)
    return torch.tensor(np.sqrt(2), dtype=bf) * torch.erfinv(u)


def normal(k: np.ndarray, shape) -> np.ndarray:
    """``jax.random.normal(k, shape)`` for float32: a uniform draw on
    ``[lo, 1)`` with ``lo = nextafter(-1, 0)`` (bit for bit the JAX
    step), then ``sqrt(2) * erfinv(u)``.  The inverse error function is
    torch's, on the CPU; XLA's polynomial differs from it in the last
    bits, so the result is within a few ulp of JAX's, not equal."""
    import torch

    f32 = np.float32
    lo = np.nextafter(f32(-1.0), f32(0.0), dtype=f32)
    u = np.maximum(lo, uniform(k, shape) * (f32(1.0) - lo) + lo)
    return (f32(np.sqrt(2)) * torch.erfinv(torch.from_numpy(u))).numpy()
