"""The few ``jax.random`` primitives the fault schedule draws from, in numpy.

The JAX package's fault schedule (``core/faults.py:fault_masks``) is a
pure function of ``(seed, round)`` built on ``jax.random`` with the
threefry2x32 generator in its partitionable mode
(``jax_threefry_partitionable = True``, the default of jax 0.9).  The
port draws the same bits here, on the host, so that a faulted port run
and a faulted JAX run of one config see the same faults.  A key is a
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
- ``bernoulli(k, p, shape)`` -> ``uniform(k, shape) < p``.

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
