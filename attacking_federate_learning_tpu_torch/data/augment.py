"""Train-time image augmentation of a round's batch.

The reference's CIFAR100 train transform (reference data_sets.py:157-166)
is reflect-pad 4 -> RandomCrop(32) -> RandomHorizontalFlip -> normalize,
per sample, in host-side torchvision workers.  The JAX package runs it
as one op over the round's (n, B, C, H, W) gather (data/augment.py
there), keyed from the experiment seed and the round index.  The port
draws the same keys, offsets and flips on the host (utils/threefry.py,
bit for bit ``jax.random``) and does the crop and flip on the batch's
device as one gather, so its augmented batch is byte-equal to JAX's.

Crop and flip act on *normalized* images while the reference crops
before normalizing; elementwise normalization commutes with both.
"""

from __future__ import annotations

import numpy as np
import torch

from attacking_federate_learning_tpu_torch.utils import threefry


def augment_draws(key: np.ndarray, m: int, pad: int = 4):
    """The (m, 2) int32 crop offsets, uniform on [0, 2 pad], and the (m,)
    flip bits (p = 0.5) of ``m`` images: JAX's ``randint`` and
    ``bernoulli`` on the two halves of ``split(key)``."""
    k_off, k_flip = threefry.split(key)
    return (threefry.randint(k_off, (m, 2), 0, 2 * pad + 1),
            threefry.bernoulli(k_flip, 0.5, (m,)))


def _reflect(idx: torch.Tensor, size: int) -> torch.Tensor:
    """Indices of a pad < size reflect padding (edge excluded, numpy's
    and torch's 'reflect') into the unpadded axis."""
    idx = idx.abs()
    return torch.where(idx >= size, 2 * (size - 1) - idx, idx)


def reflect_crop_flip(images: torch.Tensor, key: np.ndarray,
                      pad: int = 4, first: int = 0,
                      total=None) -> torch.Tensor:
    """Random crop of the reflect-padded image plus a horizontal flip,
    per image.

    images: (..., C, H, W), any number of leading batch axes, flattened
    in row-major order to the m images that draw in turn; each takes its
    own crop offset (row, column) and flip bit.  ``first`` and ``total``
    make them images ``[first, first + m)`` of a batch of ``total`` (one
    mesh position's rows of the round's batch): the draws of the whole
    batch, sliced.  One gather on ``images``' device."""
    *lead, c, h, w = images.shape
    flat = images.reshape(-1, c, h, w)
    m = flat.shape[0]
    offsets, flips = augment_draws(key, m if total is None else total, pad)
    offsets, flips = offsets[first:first + m], flips[first:first + m]
    dev = images.device
    off = torch.from_numpy(offsets.astype(np.int64)).to(dev)
    flip = torch.from_numpy(flips).to(dev)
    rows = _reflect(off[:, :1] + torch.arange(h, device=dev) - pad, h)
    cols = off[:, 1:] + torch.arange(w, device=dev) - pad
    cols = _reflect(torch.where(flip[:, None], cols.flip(1), cols), w)
    out = flat[torch.arange(m, device=dev)[:, None, None, None],
               torch.arange(c, device=dev)[None, :, None, None],
               rows[:, None, :, None], cols[:, None, None, :]]
    return out.reshape(images.shape)


def round_augment_key(seed: int, t: int) -> np.ndarray:
    """The round-t augmentation key: the round index folded into the
    experiment seed's augmentation stream."""
    return threefry.fold_in(threefry.key(seed ^ 0x5EED_A06), t)
