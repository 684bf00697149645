"""Whole CIFAR rounds: the port's engine vs the JAX engine on the CPU.

Both engines are given the same explicit dataset (the JAX engine ignores
``synth_train`` / ``synth_test`` without one) and start from the same
weights, the JAX init carried over as numpy; the port runs on the CPU,
where its kernel wrappers take their plain versions, and the JAX engine
on its XLA path (``aggregation_impl='xla'``).

- ``cifar10_cnn`` on SYNTH_CIFAR10_HARD under ALIE, n = 11, f = 2, B = 8,
  three rounds: Krum (the same winner every round) and TrimmedMean.
- A shallow WideResNet (depth 10, widen 2, 100 classes, a test-only name
  in both registries) on CIFAR100, which falls back to its synthetic
  stand-in and turns augmentation on by the auto rule: two TrimmedMean
  rounds on the augmented batches (B = 2, where no activation sits at a
  ReLU kink; see tests/test_torch_port_models.py).  At n = 5 the trimmed
  mean keeps the 3 values nearest each coordinate's median, and over
  d = 315,316 coordinates a few hold two candidates within rounding of
  each other (measured: 0.00118506 against 0.00118507), so the engines'
  1e-7 gradient differences pick different values there.  Those
  coordinates, found by comparing the kept sets of both engines' crafted
  matrices, must be near ties and few; every other weight is held to
  1e-5.
- One pattern-backdoor round of ``cifar10_cnn`` under TrimmedMean: the
  3-channel trigger, shadow training on 200-image poison batches and the
  ASR.

Final weights are held to the MNIST round test's 1e-5 (three momentum
steps at lr 0.1 of gradients that agree to a few 1e-7).
"""

import jax
import numpy as np
import pytest
import torch

from attacking_federate_learning_tpu import config as JC
from attacking_federate_learning_tpu.attacks import DriftAttack as JDrift
from attacking_federate_learning_tpu.attacks.backdoor import (
    BackdoorAttack as JBackdoor
)
from attacking_federate_learning_tpu.config import ExperimentConfig as JConfig
from attacking_federate_learning_tpu.core.engine import (
    FederatedExperiment as JExperiment
)
from attacking_federate_learning_tpu.data.datasets import (
    load_dataset as jax_load_dataset
)
from attacking_federate_learning_tpu_torch import config as C
from attacking_federate_learning_tpu_torch.attacks import (
    DriftAttack, make_attacker
)
from attacking_federate_learning_tpu_torch.config import ExperimentConfig
from attacking_federate_learning_tpu_torch.core.engine import (
    FederatedExperiment
)
from attacking_federate_learning_tpu_torch.core.server import (
    init_server_state
)
from attacking_federate_learning_tpu_torch.data.datasets import load_dataset
from attacking_federate_learning_tpu_torch.utils.weights import (
    from_jax_params
)
# The test-only shallow WRN and the module fixture that registers it.
from test_torch_port_models import SHALLOW_WRN, shallow_wrn  # noqa: F401

SIZES = dict(synth_train=600, synth_test=100)
CNN = dict(dataset=C.SYNTH_CIFAR10_HARD, users_count=11, mal_prop=0.2,
           batch_size=8, epochs=3, **SIZES)
WRN = dict(dataset=C.CIFAR100, model=SHALLOW_WRN, users_count=5,
           mal_prop=0.2, batch_size=2, epochs=2, **SIZES)


@pytest.fixture(scope="module")
def cifar10():
    return (jax_load_dataset(JC.SYNTH_CIFAR10_HARD, seed=0, **SIZES),
            load_dataset(C.SYNTH_CIFAR10_HARD, seed=0, **SIZES))


def _pair(kw, datasets, attack="alie"):
    jcfg = JConfig(**kw, aggregation_impl="xla", log_round_stats=True)
    tcfg = ExperimentConfig(**kw)
    if attack == "alie":
        jatt, tatt = JDrift(1.5), DriftAttack(1.5)
    else:
        jatt = JBackdoor(jcfg, datasets[0])
        tatt = make_attacker(tcfg, datasets[1], device="cpu")
    jexp = JExperiment(jcfg, attacker=jatt, dataset=datasets[0])
    texp = FederatedExperiment(tcfg, tatt, datasets[1], device="cpu")
    params = jax.tree.map(np.asarray, jexp.flat.unravel(jexp.state.weights))
    texp.state = init_server_state(from_jax_params(params))
    return jexp, texp


def _kept_sets(G, k):
    """(d,) keys of the trimmed mean's kept sets (the k deviations nearest
    the midpoint median, stable order) and the gap between the k-th and
    (k+1)-th smallest deviation of each column."""
    srt = np.sort(G, axis=0)
    n = G.shape[0]
    dev = np.abs(G - (srt[(n - 1) // 2] + srt[n // 2]) * np.float32(0.5))
    order = np.argsort(dev, axis=0, kind="stable")
    kept = np.sort(order[:k], axis=0)
    keys = (kept * (n ** np.arange(k))[:, None]).sum(0)
    d = np.sort(dev, axis=0)
    return keys, d[k] - d[k - 1]


def _run_and_compare(jexp, texp, rounds, krum=False, trim_ties=False):
    """Runs both engines and compares them; with ``trim_ties`` the
    coordinates whose trimmed-mean kept set differed between the engines
    in some round are left out of the weight comparison, once each is
    found to be a near tie."""
    winners, crafted = [], []
    flipped = np.zeros(texp.flat.dim, bool)
    if trim_ties:
        inner_trim = texp.defense_fn

        def record(grads, n, f, **kw):
            crafted.append(grads.numpy().copy())
            return inner_trim(grads, n, f, **kw)

        texp.defense_fn = record
    if krum:
        inner = texp.defense_fn

        def spy(grads, n, f, **kw):
            out = inner(grads, n, f, **kw)
            winners.append(np.flatnonzero((grads == out).all(1).numpy()))
            return out

        texp.defense_fn = spy
    for t in range(rounds):
        if trim_ties:
            jg = torch.from_numpy(np.array(
                jexp._compute_grads_impl(jexp.state, t)))
            jcrafted = texp.attacker.apply(jg, texp.f,
                                           texp.attack_context(t)).numpy()
        jexp.run_round(t)
        texp.run_round(t)
        if krum:
            assert int(jexp.last_round_stats["krum_selected"]) in winners[t]
        if trim_ties:
            k = texp.n - texp.f - 1
            mine, gap = _kept_sets(crafted[t], k)
            theirs, _ = _kept_sets(jcrafted, k)
            differ = mine != theirs
            scale = np.abs(crafted[t]).max(0)
            assert (gap[differ] <= 1e-5 * scale[differ]).all()
            flipped |= differ
    if trim_ties:
        assert flipped.sum() <= 1e-4 * flipped.size
    keep = ~flipped
    np.testing.assert_allclose(texp.state.weights.numpy()[keep],
                               np.asarray(jexp.state.weights)[keep],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(texp.state.velocity.numpy()[keep],
                               np.asarray(jexp.state.velocity)[keep],
                               atol=1e-5)
    jl, jc = jexp.evaluate(jexp.state.weights)
    tl, tc = texp.evaluate(texp.state.weights)
    assert int(jc) == int(tc)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


@pytest.mark.parametrize("defense", ["Krum", "TrimmedMean"])
def test_cifar10_cnn_rounds_match_the_jax_engine(defense, cifar10):
    jexp, texp = _pair(dict(CNN, defense=defense), cifar10)
    assert texp.flat.dim == 117_706 and texp.f == jexp.f == 2
    assert not texp.augment
    _run_and_compare(jexp, texp, CNN["epochs"], krum=defense == "Krum")


def test_shallow_wrn_rounds_with_augmentation_match_the_jax_engine(
        tmp_path):
    kw = dict(data_dir=str(tmp_path), seed=0, **SIZES)
    datasets = (jax_load_dataset(JC.CIFAR100, **kw),
                load_dataset(C.CIFAR100, **kw))
    assert datasets[1].name == "CIFAR100_SYNTH"
    jexp, texp = _pair(dict(WRN, defense="TrimmedMean",
                            data_dir=str(tmp_path)), datasets)
    assert texp.augment and jexp._augment
    _run_and_compare(jexp, texp, WRN["epochs"], trim_ties=True)


def test_cifar10_cnn_backdoor_round_matches_the_jax_engine(cifar10):
    kw = dict(CNN, defense="TrimmedMean", backdoor="pattern", epochs=1)
    jexp, texp = _pair(kw, cifar10, attack="backdoor")
    # 600 images: a 1/u shard with u = max(1, 600 // 200 // 10) = 1, so
    # the whole training set in 3 batches of 200, trigger on all 3
    # channels.
    assert texp.attacker.poison_x.shape == (3, 200, 3, 32, 32)
    assert bool((texp.attacker.poison_x[..., :5, :5] == 2.8).all())
    _run_and_compare(jexp, texp, 1)
    _, jpc = jexp.attacker._poison_metrics(jexp.state.weights)
    _, tpc = texp.attacker.poison_metrics(texp.state.weights)
    assert int(jpc) == int(tpc)
    lines = []
    asr = texp.attacker.test_asr(texp.state.weights, lines.append)
    assert 0.0 <= asr <= 100.0 and lines[0].startswith(
        "##Test malicious net: [POST] ")
