"""The recomputing checkpoint of the client step (models/remat.py) against
the plain step and against the JAX package's ``jax.checkpoint``.

- Per-client gradients with ``remat`` are ``torch.equal`` to those
  without, for the five models (the ResNets block by block, the others
  as one unit) at 2 clients x 2 images, at one local step and at two:
  the recompute repeats the forward's calls on the same tensors.
- One client's resnet20 loss at 32 images saves at most a quarter of the
  bytes with ``remat`` that it saves without (counted by storage under
  ``saved_tensors_hooks`` while the forward runs; measured 21 %).
- Under the client step's ``vmap(grad)`` itself, where those hooks
  cannot run, resnet20's peak of live bytes (every storage an operation
  makes, tracked below the transforms until it is freed) with ``remat``
  is at most 35 % of the plain step's at 2 clients x 8 images (measured
  27 %; a recompute kept for a second derivative, as ``grad``'s
  ``create_graph`` would keep it, measured 118 %).
- The port's engine with ``remat=True`` against the JAX engine with
  ``remat=True`` from the same weights: a flat Krum run of mnist_mlp
  and one of resnet20 at 2 images a client, within the 1e-5 of the
  whole-run tests (tests/test_torch_port_round.py).
- Engine rounds with ``remat`` are byte-equal to rounds without: flat,
  faulted, async and hierarchical, on a small mnist_mlp.
"""

import jax
import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from attacking_federate_learning_tpu import config as JC
from attacking_federate_learning_tpu.attacks import DriftAttack as JDrift
from attacking_federate_learning_tpu.config import (
    ExperimentConfig as JConfig
)
from attacking_federate_learning_tpu.core.engine import (
    FederatedExperiment as JExperiment
)
from attacking_federate_learning_tpu.data.datasets import (
    load_dataset as jax_load_dataset
)
from attacking_federate_learning_tpu_torch import config as C
from attacking_federate_learning_tpu_torch.attacks import DriftAttack
from attacking_federate_learning_tpu_torch.config import (
    ExperimentConfig, FaultConfig
)
from attacking_federate_learning_tpu_torch.core.client import (
    make_client_update_fn, make_loss_fn
)
from attacking_federate_learning_tpu_torch.core.engine import (
    FederatedExperiment
)
from attacking_federate_learning_tpu_torch.core.server import (
    init_server_state
)
from attacking_federate_learning_tpu_torch.data.datasets import load_dataset
from attacking_federate_learning_tpu_torch.models import MODELS, get_model
from attacking_federate_learning_tpu_torch.models.wideresnet import (
    make_wideresnet
)
from attacking_federate_learning_tpu_torch.utils.flatten import FlatParams
from attacking_federate_learning_tpu_torch.utils.weights import (
    from_jax_params
)

SHALLOW_WRN = "wrn10_2_remat_test"
MODEL_NAMES = ("mnist_mlp", "mnist_cnn", "cifar10_cnn", "resnet20",
               SHALLOW_WRN)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """The port on two intra-op threads, for speed: beside the other test
    workers, a machine's every core per worker spins more than it
    computes.  The remat and plain steps run at the same setting, so
    their bytes are compared at two threads as at any other count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def shallow_wrn():
    """tests/test_torch_port_models.py's shallow WRN (depth 10, widen 2)
    in the port's registry while this module runs."""
    MODELS[SHALLOW_WRN] = make_wideresnet(10, 2, 100)
    yield
    del MODELS[SHALLOW_WRN]


def _model(name):
    model = get_model(name, torch.Generator().manual_seed(0))
    flat = FlatParams(model)
    return model, flat, flat.module_vector(model)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("name", MODEL_NAMES)
def test_remat_gradients_equal_the_plain_step(name, k):
    model, flat, w = _model(name)
    n, B = 2, 2
    gen = torch.Generator().manual_seed(1)
    xs = torch.randn((n, k, B) + model.input_shape, generator=gen)
    ys = torch.randint(0, model.num_classes, (n, k, B), generator=gen)
    plain = make_client_update_fn(model, flat, k)(w, xs, ys, 0.1, 0.1)
    remat = make_client_update_fn(model, flat, k, remat=True)(
        w, xs, ys, 0.1, 0.1)
    assert plain.shape == (n, flat.dim)
    assert torch.isfinite(plain).all() and plain.abs().sum() > 0
    assert torch.equal(remat, plain)


def _saved_bytes(model, flat, w0, x, y, remat):
    """Bytes of the distinct storages the forward saves for the backward,
    and the gradient."""
    storages = {}

    def pack(t):
        storages[t.untyped_storage().data_ptr()] = (
            t.untyped_storage().nbytes())
        return t

    w = w0.clone().requires_grad_()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = make_loss_fn(model, flat, remat)(w, x, y)
    loss.backward()
    return sum(storages.values()), w.grad


def test_resnet20_remat_saves_a_quarter_of_the_bytes():
    model, flat, w = _model("resnet20")
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((32,) + model.input_shape, generator=gen)
    y = torch.randint(0, 10, (32,), generator=gen)
    plain, g_plain = _saved_bytes(model, flat, w, x, y, False)
    remat, g_remat = _saved_bytes(model, flat, w, x, y, True)
    assert remat <= 0.25 * plain
    assert torch.equal(g_remat, g_plain)


class PeakLiveBytes(TorchDispatchMode):
    """The most bytes of storage alive at once among those the operations
    under it made.  A dispatch mode sees the plain tensors below vmap and
    grad's wrappers, and a weak reference to each storage says when it
    is freed."""

    def __init__(self):
        super().__init__()
        self.live, self.peak = {}, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                ref = StorageWeakRef(t.untyped_storage())
                self.live.setdefault(ref.cdata, (ref, t.untyped_storage()
                                                 .nbytes()))
        self.live = {k: v for k, v in self.live.items()
                     if not v[0].expired()}
        self.peak = max(self.peak, sum(nb for _, nb in self.live.values()))
        return out


def test_resnet20_remat_peak_under_the_client_step():
    model, flat, w = _model("resnet20")
    gen = torch.Generator().manual_seed(3)
    xs = torch.randn((2, 8) + model.input_shape, generator=gen)
    ys = torch.randint(0, 10, (2, 8), generator=gen)
    peaks, grads = [], []
    for remat in (False, True):
        with PeakLiveBytes() as mode:
            grads.append(make_client_update_fn(model, flat, 1, remat)(
                w, xs[:, None], ys[:, None], 0.1, 0.1))
        peaks.append(mode.peak)
    assert peaks[1] <= 0.35 * peaks[0]
    assert torch.equal(grads[1], grads[0])


# ---------------------------------------------------------------------------
# whole runs: against the JAX engine, and against the remat-off run

def _jax_pair(dataset, model, n, mal_prop, batch_size, sizes):
    kw = dict(dataset=dataset, model=model, users_count=n,
              mal_prop=mal_prop, batch_size=batch_size, epochs=2,
              defense="Krum", remat=True, **sizes)
    jds = jax_load_dataset(dataset, seed=0, **sizes)
    jexp = JExperiment(JConfig(**kw, aggregation_impl="xla"),
                       attacker=JDrift(1.5), dataset=jds)
    texp = FederatedExperiment(ExperimentConfig(**kw), DriftAttack(1.5),
                               load_dataset(dataset, seed=0, **sizes),
                               device="cpu")
    params = jax.tree.map(np.asarray, jexp.flat.unravel(jexp.state.weights))
    texp.state = init_server_state(from_jax_params(params))
    return jexp, texp


@pytest.mark.parametrize("dataset,model,n,mal_prop,batch_size,sizes", [
    (JC.SYNTH_MNIST_HARD, "mnist_mlp", 19, 0.22, 32,
     dict(synth_train=1200, synth_test=300)),
    (JC.SYNTH_CIFAR10, "resnet20", 6, 0.17, 2,
     dict(synth_train=64, synth_test=16)),
], ids=["mnist_mlp", "resnet20"])
def test_remat_rounds_match_the_jax_engine_with_remat(
        dataset, model, n, mal_prop, batch_size, sizes):
    jexp, texp = _jax_pair(dataset, model, n, mal_prop, batch_size, sizes)
    assert texp.cfg.remat and jexp.cfg.remat and texp.f == jexp.f >= 1
    for t in range(2):
        jexp.run_round(t)
        texp.run_round(t)
    np.testing.assert_allclose(texp.state.weights.numpy(),
                               np.asarray(jexp.state.weights), rtol=0,
                               atol=1e-5)


SMALL = dict(dataset=C.SYNTH_MNIST, users_count=12, mal_prop=0.25,
             batch_size=8, epochs=3, synth_train=256, synth_test=64)
ROUND_KINDS = {
    "flat": dict(defense="Krum"),
    "faulted": dict(defense="TrimmedMean",
                    faults=FaultConfig(dropout=0.2, straggler=0.2,
                                       straggler_delay=1, corrupt=0.1)),
    "async": dict(defense="TrimmedMean", aggregation="async",
                  async_buffer=8, staleness_weight="poly"),
    "hierarchical": dict(defense="Median", aggregation="hierarchical",
                         megabatch=4, tier2_defense="Krum"),
}


@pytest.fixture(scope="module")
def small_dataset():
    return load_dataset(C.SYNTH_MNIST, seed=0, synth_train=256,
                        synth_test=64)


@pytest.mark.parametrize("kind", list(ROUND_KINDS))
def test_remat_rounds_are_byte_equal_to_plain_rounds(kind, small_dataset):
    finals = []
    for remat in (False, True):
        cfg = ExperimentConfig(**SMALL, **ROUND_KINDS[kind], remat=remat)
        exp = FederatedExperiment(cfg, DriftAttack(1.5), small_dataset,
                                  device="cpu")
        for t in range(cfg.epochs):
            exp.run_round(t)
        finals.append(exp.state.weights.clone())
    assert torch.isfinite(finals[0]).all()
    assert torch.equal(finals[1], finals[0])
