"""Datasets as dense numpy arrays (MNIST-shaped slice of the port).

A dataset is a pair of dense arrays (images normalized up-front, labels
int32); the engine moves them to the device once and a round's batch for
every client is one gather.  The MNIST idx reader reads the raw
distribution files directly; when they are absent the SYNTH_* datasets
give deterministic, learnable class-structured data with identical
shapes and normalization.  Everything here is numpy made from ``seed``,
so the same seed gives byte-identical arrays to the JAX package's loader.

Normalization matches the reference transform: MNIST (x-0.1307)/0.3081
(reference data_sets.py:26-27).
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import NamedTuple

import numpy as np

from attacking_federate_learning_tpu_torch import config as C


class Dataset(NamedTuple):
    name: str
    train_x: np.ndarray   # (N, 1, 28, 28) normalized float32
    train_y: np.ndarray   # (N,) int32
    test_x: np.ndarray
    test_y: np.ndarray
    num_classes: int


MNIST_MEAN, MNIST_STD = 0.1307, 0.3081


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


def make_synthetic(shape, num_classes: int, n_train: int, n_test: int,
                   seed: int, name: str, mean, std, signal: float = 0.35,
                   noise_scale: float = 0.25) -> Dataset:
    """Class-prototype Gaussians in pixel space, then normalized.

    Each class c gets a fixed prototype image p_c; samples are
    clip(0.5 + signal*p_c + noise_scale*noise, 0, 1), with a quiet
    4-pixel border on 1-channel 28x28 images (real digits leave the
    margin near zero).  Lower signal-to-noise (the *_HARD variant) slows
    convergence so attack-vs-defense accuracy deltas stay visible.
    """
    rng = np.random.default_rng(seed)
    protos = rng.standard_normal((num_classes,) + shape).astype(np.float32)
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
    if name == C.SYNTH_MNIST:
        return make_synthetic((1, 28, 28), 10, synth_train, synth_test, seed,
                              C.SYNTH_MNIST, MNIST_MEAN, MNIST_STD)
    if name == C.SYNTH_MNIST_HARD:
        # Low SNR: converges over tens of rounds instead of a handful, so
        # Byzantine attacks produce measurable accuracy deltas.
        return make_synthetic((1, 28, 28), 10, synth_train, synth_test, seed,
                              name, MNIST_MEAN, MNIST_STD,
                              signal=0.12, noise_scale=0.30)
    raise ValueError(f"Unknown dataset {name!r}")
