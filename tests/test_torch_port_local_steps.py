"""Local steps: the port's ``make_client_update_fn`` and engine vs JAX's.

- k = 1 is the FedSGD gradient: bit for bit the port's
  ``make_client_grad_fn`` (the learning rates unused), and the JAX
  function's gradients within the fp32 band of
  tests/test_torch_port_round.py.
- k = 3: each client's pseudo-gradient ``(w0 - w_k) / lr_report``
  against the JAX function's on the same weights and batches.  The
  subtraction cancels: w0 - w_k is about k lr |g| while each w carries
  eps |w| of rounding, so the two frameworks' pseudo-gradients differ by
  a few eps |w0| / lr_report, held relative to ||w0 - w_k|| per client.
- Whole runs at k = 3 against the JAX engine under both
  ``server_uses_faded_lr`` settings (NoDefense, Krum, Median: selections
  and means of the pseudo-gradients), and the JAX package's
  test_local_steps_reduction_is_exact_under_server_lr.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attacking_federate_learning_tpu import config as JC
from attacking_federate_learning_tpu.attacks import DriftAttack as JDrift
from attacking_federate_learning_tpu.config import (
    ExperimentConfig as JConfig
)
from attacking_federate_learning_tpu.core.client import (
    make_client_update_fn as jax_client_update_fn
)
from attacking_federate_learning_tpu.core.engine import (
    FederatedExperiment as JExperiment
)
from attacking_federate_learning_tpu.data.datasets import (
    load_dataset as jax_load_dataset
)
from attacking_federate_learning_tpu_torch import config as C
from attacking_federate_learning_tpu_torch.attacks import DriftAttack
from attacking_federate_learning_tpu_torch.config import ExperimentConfig
from attacking_federate_learning_tpu_torch.core.client import (
    make_client_grad_fn, make_client_update_fn
)
from attacking_federate_learning_tpu_torch.core.engine import (
    FederatedExperiment, faded_lr
)
from attacking_federate_learning_tpu_torch.core.server import (
    init_server_state
)
from attacking_federate_learning_tpu_torch.data.datasets import load_dataset
from attacking_federate_learning_tpu_torch.utils.weights import (
    from_jax_params
)

SIZES = dict(synth_train=1200, synth_test=300)
N, MAL_PROP, B, ROUNDS, K = 19, 0.22, 32, 3, 3


@pytest.fixture(scope="module")
def datasets():
    return (jax_load_dataset(JC.SYNTH_MNIST_HARD, seed=0, **SIZES),
            load_dataset(C.SYNTH_MNIST_HARD, seed=0, **SIZES))


def _pair(datasets, defense="NoDefense", **extra):
    kw = dict(dataset=C.SYNTH_MNIST_HARD, users_count=N, mal_prop=MAL_PROP,
              batch_size=B, epochs=ROUNDS, defense=defense, **SIZES)
    kw.update({"local_steps": K, **extra})
    jexp = JExperiment(JConfig(**kw, aggregation_impl="xla"),
                       attacker=JDrift(1.5), dataset=datasets[0])
    texp = FederatedExperiment(ExperimentConfig(**kw), DriftAttack(1.5),
                               datasets[1], device="cpu")
    params = jax.tree.map(np.asarray, jexp.flat.unravel(jexp.state.weights))
    texp.state = init_server_state(from_jax_params(params))
    return jexp, texp


def _batches(jexp, t, k):
    xs, ys = jexp._gather_batches(jnp.int32(t))
    xs = np.asarray(xs).reshape((N, k, B) + np.asarray(xs).shape[2:])
    return xs, np.asarray(ys).reshape((N, k, B))


def test_one_step_is_the_fedsgd_gradient(datasets):
    jexp, texp = _pair(datasets, local_steps=1)
    xs, ys = _batches(jexp, 0, 1)
    w = texp.state.weights
    lr = torch.tensor(faded_lr(texp.cfg, 0))
    got = make_client_update_fn(texp.model, texp.flat, 1)(
        w, torch.from_numpy(xs), torch.from_numpy(ys).long(), lr, 0.1)
    base = make_client_grad_fn(texp.model, texp.flat)(
        w, torch.from_numpy(xs[:, 0]), torch.from_numpy(ys[:, 0]).long())
    assert torch.equal(got, base)
    want = np.asarray(jax_client_update_fn(jexp.model, jexp.flat, 1)(
        jexp.state.weights, jnp.asarray(xs), jnp.asarray(ys),
        jnp.float32(lr), 0.1))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("faded", [False, True])
def test_three_steps_match_jax(faded, datasets):
    jexp, texp = _pair(datasets)
    xs, ys = _batches(jexp, 2, K)
    lr = faded_lr(texp.cfg, 2)
    lr_report = lr if faded else texp.cfg.learning_rate
    lr_t = torch.tensor(lr)
    got = make_client_update_fn(texp.model, texp.flat, K)(
        texp.state.weights, torch.from_numpy(xs),
        torch.from_numpy(ys).long(), lr_t, lr_t if faded else lr_report)
    jlr = jnp.float32(lr)
    want = np.asarray(jax_client_update_fn(jexp.model, jexp.flat, K)(
        jexp.state.weights, jnp.asarray(xs), jnp.asarray(ys), jlr,
        jlr if faded else lr_report))
    assert got.shape == want.shape == (N, texp.flat.dim)
    # The pseudo-gradient is (w0 - w_k) / lr_report: per client, its
    # difference from JAX's within 1e-5 of its own norm (the cancellation
    # band: a few eps |w0| / lr_report per weight; measured ~1e-7).
    diff = np.linalg.norm(got.numpy() - want, axis=1)
    assert (diff <= 1e-5 * np.linalg.norm(want, axis=1)).all()
    # k steps at lr move the weights k times as far as one gradient step:
    # the pseudo-gradient is not the one-step gradient.
    one = make_client_grad_fn(texp.model, texp.flat)(
        texp.state.weights, torch.from_numpy(xs[:, 0]),
        torch.from_numpy(ys[:, 0]).long())
    assert not torch.allclose(got, one)


@pytest.mark.parametrize("defense", ["NoDefense", "Krum", "Median"])
@pytest.mark.parametrize("faded", [False, True])
def test_three_rounds_of_local_steps_match_the_jax_engine(defense, faded,
                                                          datasets):
    jexp, texp = _pair(datasets, defense, server_uses_faded_lr=faded)
    for t in range(ROUNDS):
        jexp.run_round(t)
        texp.run_round(t)
    # Three momentum steps of pseudo-gradients within 1e-5 of their norm:
    # the weights stay within 1e-5 (measured ~1e-7).
    np.testing.assert_allclose(texp.state.weights.numpy(),
                               np.asarray(jexp.state.weights), rtol=0,
                               atol=1e-5)


def test_local_steps_reduction_is_exact_under_server_lr(datasets):
    """The JAX package's test of the same name: one server round at
    momentum 0 on the constant server lr lands on the weights the single
    client reaches by k plain SGD steps at the faded lr."""
    cfg = ExperimentConfig(dataset=C.SYNTH_MNIST, users_count=1,
                           mal_prop=0.0, batch_size=8, epochs=1,
                           defense="NoDefense", local_steps=3, momentum=0.0,
                           synth_train=64, synth_test=32)
    ds = load_dataset(cfg.dataset, seed=0, synth_train=64, synth_test=32)
    exp = FederatedExperiment(cfg, dataset=ds, device="cpu")
    w = exp.state.weights.clone()
    xs, ys = exp.gather_batches(0)
    xs = xs.reshape((1, 3, 8) + xs.shape[2:])
    ys = ys.reshape(1, 3, 8)
    lr = faded_lr(cfg, 0)
    grad = make_client_grad_fn(exp.model, exp.flat)
    for s in range(3):
        w = w - lr * grad(w, xs[:, s], ys[:, s])[0]
    exp.run_round(0)
    np.testing.assert_allclose(exp.state.weights.numpy(), w.numpy(),
                               atol=1e-6, rtol=1e-6)
