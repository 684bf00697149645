"""The port's train-time augmentation vs the JAX package's data/augment.py.

The crop and flip only move data, so the port's augmented batch must be
byte-equal to JAX's for the same seed and round; under it lie the host
draws ``threefry.randint`` and ``threefry.bernoulli``, bit-equal to
``jax.random``'s.  The engine follows JAX's auto rule (augment iff the
dataset is CIFAR100, unless ``data_augment`` says otherwise) and refuses
flat data with JAX's message.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attacking_federate_learning_tpu.data import augment as jaug
from attacking_federate_learning_tpu_torch import cli
from attacking_federate_learning_tpu_torch import config as C
from attacking_federate_learning_tpu_torch.config import ExperimentConfig
from attacking_federate_learning_tpu_torch.core.engine import (
    FederatedExperiment
)
from attacking_federate_learning_tpu_torch.data import augment as taug
from attacking_federate_learning_tpu_torch.data.datasets import (
    Dataset, load_dataset
)
from attacking_federate_learning_tpu_torch.utils import threefry

KEYS = [(0, 0), (1, 3), (12345, 7), (2 ** 31 + 7, 99)]


def _keys(seed, t):
    jk = jax.random.fold_in(jax.random.key(seed), t)
    tk = threefry.fold_in(threefry.key(seed), t)
    assert np.array_equal(np.asarray(jax.random.key_data(jk)), tk)
    return jk, tk


@pytest.mark.parametrize("shape,lo,hi", [
    ((7, 2), 0, 9), ((1000,), -5, 300), ((3, 4, 5), 0, 1), ((10,), 5, 5),
    ((100,), -2 ** 31, 2 ** 31 - 1), ((50,), 0, 100_000)])
@pytest.mark.parametrize("seed,t", KEYS)
def test_randint_is_jax_s_bit_for_bit(seed, t, shape, lo, hi):
    jk, tk = _keys(seed, t)
    want = np.asarray(jax.random.randint(jk, shape, lo, hi))
    got = threefry.randint(tk, shape, lo, hi)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("p,shape", [(0.5, (257,)), (0.1, (4, 9)),
                                     (0.9, (1,))])
@pytest.mark.parametrize("seed,t", KEYS)
def test_bernoulli_is_jax_s_bit_for_bit(seed, t, p, shape):
    jk, tk = _keys(seed, t)
    want = np.asarray(jax.random.bernoulli(jk, p, shape))
    got = threefry.bernoulli(tk, p, shape)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("t", [0, 1, 20, 299])
def test_reflect_crop_flip_is_byte_equal_to_jax(seed, t):
    x = np.random.default_rng(t).standard_normal(
        (4, 6, 3, 32, 32)).astype(np.float32)
    assert np.array_equal(
        np.asarray(jax.random.key_data(jaug.round_augment_key(seed, t))),
        taug.round_augment_key(seed, t))
    want = np.asarray(jaug.reflect_crop_flip(
        jnp.asarray(x), jaug.round_augment_key(seed, t)))
    got = taug.reflect_crop_flip(torch.from_numpy(x),
                                 taug.round_augment_key(seed, t)).numpy()
    assert got.shape == want.shape and got.tobytes() == want.tobytes()


def test_crop_offsets_and_flips_cover_their_ranges():
    """Every offset in [0, 8] per axis and both flip values occur over a
    round of 100 x 128 images, and a crop with offset (4, 4) and no flip
    is the identity."""
    off, flips = taug.augment_draws(taug.round_augment_key(0, 0), 12_800)
    assert sorted(np.unique(off)) == list(range(9))
    assert 0.45 < flips.mean() < 0.55
    i = int(np.flatnonzero((off == 4).all(1) & ~flips)[0])
    x = torch.randn(12_800, 1, 8, 8)
    out = taug.reflect_crop_flip(x, taug.round_augment_key(0, 0))
    assert torch.equal(out[i], x[i])


def _cfg(dataset, **kw):
    return ExperimentConfig(dataset=dataset, model="cifar10_cnn",
                            users_count=4, mal_prop=0.0, batch_size=4,
                            synth_train=64, synth_test=16, **kw)


@pytest.mark.parametrize("dataset,data_augment,want", [
    (C.CIFAR100, None, True), (C.CIFAR10, None, False),
    (C.SYNTH_CIFAR10_HARD, None, False), (C.SYNTH_CIFAR10, True, True),
    (C.CIFAR100, False, False)])
def test_auto_rule_follows_jax(dataset, data_augment, want, tmp_path):
    exp = FederatedExperiment(
        _cfg(dataset, data_augment=data_augment, data_dir=str(tmp_path)),
        device="cpu")
    assert exp.augment is want


def test_round_batch_is_augmented_before_deliver():
    cfg = _cfg(C.SYNTH_CIFAR10, data_augment=True)
    exp = FederatedExperiment(cfg, device="cpu")
    xs, ys = exp.gather_batches(3)
    want = taug.reflect_crop_flip(xs, taug.round_augment_key(cfg.seed, 3))
    grads = exp._client_update(exp.state.weights, want[:, None],
                                ys[:, None], 0.0, 1.0)
    assert torch.equal(exp.compute_grads(3), grads.contiguous())
    assert not torch.equal(want, xs)


def test_flat_data_is_refused_with_jax_s_message():
    ds = load_dataset(C.SYNTH_CIFAR10, synth_train=64, synth_test=16)
    flat = Dataset(ds.name, ds.train_x.reshape(64, -1), ds.train_y,
                   ds.test_x.reshape(16, -1), ds.test_y, ds.num_classes)
    with pytest.raises(ValueError) as err:
        FederatedExperiment(_cfg(C.SYNTH_CIFAR10, data_augment=True),
                            dataset=flat, device="cpu")
    assert str(err.value) == ("data_augment needs (N, C, H, W) images, got "
                              "shape (64, 3072) for SYNTH_CIFAR10")


def test_cli_takes_model_and_augment():
    p = cli.build_parser()
    args = p.parse_args(["-s", "SYNTH_CIFAR10_HARD", "--model", "resnet20",
                         "--augment", "on"])
    cfg = cli.config_from_args(args)
    assert (cfg.dataset, cfg.model, cfg.data_augment) == (
        C.SYNTH_CIFAR10_HARD, "resnet20", True)
    cfg = cli.config_from_args(p.parse_args(["-s", "CIFAR100"]))
    assert (cfg.model, cfg.data_augment, cfg.fading_rate) == (
        "wideresnet40_4", None, 1500.0)
    with pytest.raises(SystemExit):
        p.parse_args(["--augment", "maybe"])
