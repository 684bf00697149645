"""The port's model, wire format, client gradients and data vs the JAX
package.

The JAX model's parameters are carried into the port as numpy arrays
(``utils/weights.py:from_jax_params``); the same weights must give the
same log-probabilities and the same per-client (n, d) gradients.  The
datasets, shards and round batches are numpy from a seed and must be
byte-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attacking_federate_learning_tpu import config as JC
from attacking_federate_learning_tpu.core.client import (
    make_client_grad_fn as jax_client_grad_fn
)
from attacking_federate_learning_tpu.data import datasets as jds
from attacking_federate_learning_tpu.data import partition as jpart
from attacking_federate_learning_tpu.models.base import get_model
from attacking_federate_learning_tpu.utils.flatten import make_flattener
from attacking_federate_learning_tpu_torch.core.client import (
    make_client_grad_fn
)
from attacking_federate_learning_tpu_torch.data import datasets as tds
from attacking_federate_learning_tpu_torch.data import partition as tpart
from attacking_federate_learning_tpu_torch.models import get_model as tget
from attacking_federate_learning_tpu_torch.utils.flatten import FlatParams
from attacking_federate_learning_tpu_torch.utils.weights import (
    from_jax_params, to_jax_params
)


@pytest.fixture(scope="module")
def carried():
    """JAX mnist_mlp params (seeded), the port's module and flat view, and
    the carried flat weights."""
    model = get_model("mnist_mlp")
    params = model.init(jax.random.key(3))
    params_np = jax.tree.map(np.asarray, params)
    tmodel = tget("mnist_mlp", torch.Generator().manual_seed(0))
    return model, params, params_np, tmodel, FlatParams(tmodel)


def test_wire_order_and_dim(carried):
    model, params, params_np, tmodel, flat = carried
    assert flat.names == ["fc1.weight", "fc1.bias", "fc2.weight",
                          "fc2.bias"]
    assert flat.dim == 79_510 == make_flattener(params).dim
    w = from_jax_params(params_np)
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(make_flattener(params).ravel(params)))
    back = to_jax_params(w, tmodel)
    for layer in ("fc1", "fc2"):
        for leaf in ("weight", "bias"):
            np.testing.assert_array_equal(back[layer][leaf],
                                          params_np[layer][leaf])


def test_carried_weights_give_the_same_log_probs(carried):
    model, params, params_np, tmodel, flat = carried
    x = np.random.default_rng(0).standard_normal((16, 1, 28, 28)).astype(
        np.float32)
    want = np.asarray(model.apply(params, jnp.asarray(x)))
    w = from_jax_params(params_np)
    got = torch.func.functional_call(
        tmodel, flat.unflatten(w), (torch.from_numpy(x),)).detach().numpy()
    # fp32 matmuls in another order: a few ulp of values of order 1-10.
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


def test_per_client_gradients_match_jax(carried):
    model, params, params_np, tmodel, flat = carried
    n, B = 6, 16
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((n, B, 1, 28, 28)).astype(np.float32)
    ys = rng.integers(0, 10, (n, B)).astype(np.int32)
    jflat = make_flattener(params)
    want = np.asarray(jax_client_grad_fn(model, jflat)(
        jflat.ravel(params), jnp.asarray(xs), jnp.asarray(ys)))
    got = make_client_grad_fn(tmodel, flat)(
        from_jax_params(params_np), torch.from_numpy(xs),
        torch.from_numpy(ys).long()).numpy()
    assert got.shape == (n, 79_510)
    # Gradient entries are O(1e-2); fp32 reduction order differs.
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_default_init_follows_the_reference_rules():
    m = tget("mnist_mlp", torch.Generator().manual_seed(0))
    w1, w2 = m.fc1.weight.detach(), m.fc2.weight.detach()
    bound1 = float(np.sqrt(6.0 / (784 + 100)))       # xavier-uniform fc1
    assert float(w1.abs().max()) <= bound1
    assert float(w1.abs().max()) > 0.9 * bound1
    assert float(w2.abs().max()) <= 1.0 / np.sqrt(100)
    m2 = tget("mnist_mlp", torch.Generator().manual_seed(0))
    assert torch.equal(m.fc1.weight, m2.fc1.weight)  # a function of seed


@pytest.mark.parametrize("name", [JC.SYNTH_MNIST, JC.SYNTH_MNIST_HARD,
                                  JC.MNIST])
def test_datasets_are_byte_identical(name, tmp_path):
    kw = dict(data_dir=str(tmp_path), seed=5, synth_train=300,
              synth_test=70)
    a = jds.load_dataset(name, **kw)
    b = tds.load_dataset(name, **kw)
    assert a.name == b.name and a.num_classes == b.num_classes
    for x, y in zip(a[1:5], b[1:5]):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def test_shards_and_round_batches_are_identical():
    labels = tds.load_dataset(JC.SYNTH_MNIST, seed=1, synth_train=500,
                              synth_test=10).train_y
    for partition in ("iid", "dirichlet"):
        a = jpart.make_shards(partition, labels, 7, seed=2,
                              dirichlet_alpha=0.3)
        b = tpart.make_shards(partition, labels, 7, seed=2,
                              dirichlet_alpha=0.3)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        for t in (0, 5, 123):
            np.testing.assert_array_equal(
                np.asarray(jpart.round_batch_indices(jnp.asarray(a), t, 32)),
                tpart.round_batch_indices(torch.from_numpy(b), t,
                                          32).numpy())
