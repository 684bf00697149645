"""Datasets as dense numpy arrays.

A dataset is a pair of dense arrays (images normalized up-front, labels
int32); the engine moves them to the device once and a round's batch for
every client is one gather.  The loaders read the raw distribution files
directly (MNIST IDX, CIFAR-10/100 python pickles); when they are absent
the SYNTH_* datasets give deterministic, learnable class-structured data
with identical shapes and normalization (CIFAR100 falls back to a
100-class ``CIFAR100_SYNTH``).  Everything here is numpy made from
``seed``, so the same seed gives byte-identical arrays to the JAX
package's loader.

Normalization matches the reference transforms: MNIST (x-0.1307)/0.3081
(reference data_sets.py:26-27), CIFAR10 (x-0.5)/0.5 (data_sets.py:56-57),
CIFAR100 per-channel stats (data_sets.py:154-155).
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
from typing import NamedTuple

import numpy as np

from attacking_federate_learning_tpu_torch import config as C


class Dataset(NamedTuple):
    name: str
    train_x: np.ndarray   # (N, C, H, W) normalized float32
    train_y: np.ndarray   # (N,) int32
    test_x: np.ndarray
    test_y: np.ndarray
    num_classes: int


MNIST_MEAN, MNIST_STD = 0.1307, 0.3081
CIFAR10_MEAN, CIFAR10_STD = 0.5, 0.5
CIFAR100_MEAN = np.array([125.3, 123.0, 113.9], np.float32) / 255.0
CIFAR100_STD = np.array([63.0, 62.1, 66.7], np.float32) / 255.0


def _open_maybe_gz(path):
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    return open(path, "rb")


def _read_idx(path) -> np.ndarray:
    with _open_maybe_gz(path) as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


def load_mnist(data_dir: str) -> Dataset:
    d = os.path.join(data_dir, "MNIST", "raw")
    if not os.path.isdir(d):
        d = data_dir
    tx = _read_idx(os.path.join(d, "train-images-idx3-ubyte"))
    ty = _read_idx(os.path.join(d, "train-labels-idx1-ubyte"))
    vx = _read_idx(os.path.join(d, "t10k-images-idx3-ubyte"))
    vy = _read_idx(os.path.join(d, "t10k-labels-idx1-ubyte"))

    def norm(x):
        x = x.astype(np.float32) / 255.0
        return ((x - MNIST_MEAN) / MNIST_STD)[:, None, :, :]  # (N,1,28,28)

    return Dataset("MNIST", norm(tx), ty.astype(np.int32),
                   norm(vx), vy.astype(np.int32), 10)


def _load_cifar_pickles(paths, key_x=b"data", key_y=b"labels"):
    # The CIFAR python distribution's own pickles, read from data_dir;
    # nothing else is unpickled here.
    xs, ys = [], []
    for p in paths:
        with open(p, "rb") as f:
            batch = pickle.load(f, encoding="bytes")
        xs.append(batch[key_x])
        ys.extend(batch[key_y])
    x = np.concatenate(xs).reshape(-1, 3, 32, 32)
    return x, np.asarray(ys, np.int32)


def load_cifar10(data_dir: str) -> Dataset:
    d = os.path.join(data_dir, "cifar-10-batches-py")
    if not os.path.isdir(d):
        d = data_dir
    tx, ty = _load_cifar_pickles(
        [os.path.join(d, f"data_batch_{i}") for i in range(1, 6)])
    vx, vy = _load_cifar_pickles([os.path.join(d, "test_batch")])

    def norm(x):
        return (x.astype(np.float32) / 255.0 - CIFAR10_MEAN) / CIFAR10_STD

    return Dataset("CIFAR10", norm(tx), ty, norm(vx), vy, 10)


def load_cifar100(data_dir: str) -> Dataset:
    d = os.path.join(data_dir, "cifar-100-python")
    if not os.path.isdir(d):
        d = data_dir
    tx, ty = _load_cifar_pickles([os.path.join(d, "train")],
                                 key_y=b"fine_labels")
    vx, vy = _load_cifar_pickles([os.path.join(d, "test")],
                                 key_y=b"fine_labels")

    def norm(x):
        x = x.astype(np.float32) / 255.0
        return (x - CIFAR100_MEAN[:, None, None]) / CIFAR100_STD[:, None, None]

    return Dataset("CIFAR100", norm(tx), ty, norm(vx), vy, 100)


def make_synthetic(shape, num_classes: int, n_train: int, n_test: int,
                   seed: int, name: str, mean, std, signal: float = 0.35,
                   noise_scale: float = 0.25,
                   smooth_protos: bool = False) -> Dataset:
    """Class-prototype Gaussians in pixel space, then normalized.

    Each class c gets a fixed prototype image p_c; samples are
    clip(0.5 + signal*p_c + noise_scale*noise, 0, 1), with a quiet
    4-pixel border on 1-channel 28x28 images (real digits leave the
    margin near zero).  Lower signal-to-noise (the *_HARD variants) slows
    convergence so attack-vs-defense accuracy deltas stay visible.

    ``smooth_protos`` draws the prototypes on a coarse (H/4, W/4) grid
    and nearest-upsamples them: a conv + pool net barely sees per-pixel
    i.i.d. prototypes (the JAX package measured cifar10_cnn at random
    accuracy on them), so the CNN-targeted set is spatially smooth.  The
    branch draws from ``rng`` only when it is taken, so every other set
    keeps its bytes.
    """
    rng = np.random.default_rng(seed)
    if smooth_protos and len(shape) == 3 and shape[1] % 4 == 0 \
            and shape[2] % 4 == 0:
        coarse = rng.standard_normal(
            (num_classes, shape[0], shape[1] // 4, shape[2] // 4)
        ).astype(np.float32)
        protos = np.kron(coarse, np.ones((1, 1, 4, 4), np.float32))
    else:
        protos = rng.standard_normal(
            (num_classes,) + shape).astype(np.float32)
    protos /= np.linalg.norm(protos.reshape(num_classes, -1), axis=1).reshape(
        (num_classes,) + (1,) * len(shape)) / np.sqrt(np.prod(shape))

    border = 4 if (shape[0] == 1 and shape[-1] >= 28) else 0
    if border:
        edge_mask = np.zeros(shape, np.float32)
        edge_mask[..., border:-border, border:-border] = 1.0
    else:
        edge_mask = np.ones(shape, np.float32)

    def gen(n):
        y = rng.integers(0, num_classes, size=n).astype(np.int32)
        noise = rng.standard_normal((n,) + shape).astype(np.float32)
        x = np.clip((0.5 + signal * protos[y] + noise_scale * noise)
                    * edge_mask, 0.0, 1.0)
        return (x - mean) / std, y

    tx, ty = gen(n_train)
    vx, vy = gen(n_test)
    return Dataset(name, tx, ty, vx, vy, num_classes)


def load_dataset(name: str, data_dir: str = "data", seed: int = 0,
                 synth_train: int = 10000, synth_test: int = 2000,
                 ) -> Dataset:
    if name == C.MNIST:
        try:
            return load_mnist(data_dir)
        except (FileNotFoundError, OSError):
            name = C.SYNTH_MNIST
    if name == C.CIFAR10:
        try:
            return load_cifar10(data_dir)
        except (FileNotFoundError, OSError):
            name = C.SYNTH_CIFAR10
    if name == C.CIFAR100:
        try:
            return load_cifar100(data_dir)
        except (FileNotFoundError, OSError):
            return make_synthetic(
                (3, 32, 32), 100, synth_train, synth_test, seed,
                C.CIFAR100 + "_SYNTH",
                CIFAR100_MEAN[:, None, None], CIFAR100_STD[:, None, None])
    if name == C.SYNTH_MNIST:
        return make_synthetic((1, 28, 28), 10, synth_train, synth_test, seed,
                              C.SYNTH_MNIST, MNIST_MEAN, MNIST_STD)
    if name == C.SYNTH_CIFAR10:
        return make_synthetic((3, 32, 32), 10, synth_train, synth_test, seed,
                              C.SYNTH_CIFAR10, CIFAR10_MEAN, CIFAR10_STD)
    if name == C.SYNTH_MNIST_HARD:
        # Low SNR: converges over tens of rounds instead of a handful, so
        # Byzantine attacks produce measurable accuracy deltas.
        return make_synthetic((1, 28, 28), 10, synth_train, synth_test, seed,
                              name, MNIST_MEAN, MNIST_STD,
                              signal=0.12, noise_scale=0.30)
    if name == C.SYNTH_CIFAR10_HARD:
        # Spatially smooth prototypes, so a CNN can learn them, at an SNR
        # low enough that training stays unsaturated over ~100+ rounds.
        return make_synthetic((3, 32, 32), 10, synth_train, synth_test, seed,
                              name, CIFAR10_MEAN, CIFAR10_STD,
                              signal=0.20, noise_scale=0.30,
                              smooth_protos=True)
    raise ValueError(f"Unknown dataset {name!r}")
