"""The port's model family vs the JAX package's: wire format, carried
weights, log-probabilities, per-client gradients, the CIFAR datasets and
the config's model knobs.

Every model of the JAX CLI's ``--model`` choices, plus a shallow
WideResNet (depth 10, widen 2) registered here under a test-only name in
both registries, is built in both packages.  The JAX init is carried into
the port as numpy (``utils/weights.py``); the same weights must give the
same parameter paths, shapes and d, the same log-probabilities and the
same per-client (n, d) gradients on seeded numpy inputs.

Tolerances are held against an fp64 run of the port on the same weights
and inputs:

- log-probs: both fp32 runs within 1e-5 of fp64 (measured <= 1.4e-6 on
  values of order 1-5);
- gradients: each client's fp32 gradient within 1e-5 of fp64 in relative
  L2 norm, and the port's and JAX's within 2e-5 of each other (measured
  <= 2e-6).  The ResNets at 3-4 images a client are the exception: their
  BatchNorm over so few images puts some pre-ReLU activations within
  rounding of 0, where ReLU's derivative jumps, and an fp32 run (JAX's or
  the port's) that lands on the other side of the kink than fp64 moves
  every gradient upstream of it (measured up to 7.6e-3 for the port and
  6.7e-3 for JAX).  There both fp32 runs are held to 2e-2 of fp64 in
  relative L2 norm; the same models at 2 images a client, where no
  activation sits at a kink, are held to the tight band.
"""

import functools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attacking_federate_learning_tpu import cli as jcli
from attacking_federate_learning_tpu import config as JC
from attacking_federate_learning_tpu.config import ExperimentConfig as JConfig
from attacking_federate_learning_tpu.core.client import (
    make_client_grad_fn as jax_client_grad_fn
)
from attacking_federate_learning_tpu.core.evaluate import (
    make_eval_fn as jax_make_eval_fn
)
from attacking_federate_learning_tpu.data import datasets as jds
from attacking_federate_learning_tpu.models.base import MODELS as JMODELS
from attacking_federate_learning_tpu.models.base import get_model
from attacking_federate_learning_tpu.models.wideresnet import (
    make_wideresnet as jax_make_wideresnet
)
from attacking_federate_learning_tpu.utils.flatten import make_flattener
from attacking_federate_learning_tpu_torch import config as C
from attacking_federate_learning_tpu_torch.config import ExperimentConfig
from attacking_federate_learning_tpu_torch.core.client import (
    make_client_grad_fn, make_client_update_fn
)
from attacking_federate_learning_tpu_torch.core.evaluate import make_eval_fn
from attacking_federate_learning_tpu_torch.data import datasets as tds
from attacking_federate_learning_tpu_torch.models import MODELS
from attacking_federate_learning_tpu_torch.models import get_model as tget
from attacking_federate_learning_tpu_torch.models.wideresnet import (
    make_wideresnet
)
from attacking_federate_learning_tpu_torch.utils.flatten import FlatParams
from attacking_federate_learning_tpu_torch.utils.weights import (
    from_jax_params, to_jax_params
)

SHALLOW_WRN = "wrn10_2_test"


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """The port on two intra-op threads, for speed: beside the other test
    workers, a machine's every core per worker spins more than it
    computes.  Each comparison here is with JAX or fp64 within a band, or
    within one process, but one (:func:`machine_threads`)."""
    threads = _MACHINE_THREADS[0] = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# The machine's intra-op thread count, kept by :func:`two_threads`.
_MACHINE_THREADS = [None]


@pytest.fixture
def machine_threads():
    """The machine's thread count for one test whose bits (one client
    alone against the same client in a batch of two, atol 1e-7) move by
    an ulp at two threads."""
    torch.set_num_threads(_MACHINE_THREADS[0])
    yield
    torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def shallow_wrn():
    """The test-only shallow WRN in both registries while this module's
    tests run; taken out again after them, since other modules compare
    the registries' names with the CLI's choices."""
    JMODELS.register(SHALLOW_WRN, lambda: jax_make_wideresnet(
        10, 2, 100, name=SHALLOW_WRN))
    MODELS[SHALLOW_WRN] = make_wideresnet(10, 2, 100)
    yield
    del JMODELS._entries[SHALLOW_WRN]
    del MODELS[SHALLOW_WRN]

DIMS = {"mnist_mlp": 79_510, "mnist_cnn": 21_840, "cifar10_cnn": 117_706,
        "resnet20": 272_282, "wideresnet40_4": 8_972_340,
        SHALLOW_WRN: 315_316}
BATCH_STATS = ("resnet20", SHALLOW_WRN)
KINK_BAND = 2e-2     # relative L2, BN models at 3-4 images (docstring)
TIGHT_BAND = 1e-5


def _paths(tree, prefix=""):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _paths(value, prefix + key + ".")
        else:
            yield prefix + key, tuple(value.shape)


@functools.lru_cache(maxsize=None)
def _carry(name):
    """The JAX model and its seeded init, the port's module and its flat
    view (built once per model; the tests do not mutate them)."""
    model = get_model(name)
    params = model.init(jax.random.key(1))
    tmodel = tget(name, torch.Generator().manual_seed(0))
    return model, params, tmodel, FlatParams(tmodel)


@pytest.mark.parametrize("name", list(DIMS))
def test_wire_paths_order_and_dim(name):
    model, params, tmodel, flat = _carry(name)
    want = list(_paths(params))
    assert flat.names == [p for p, _ in want]
    assert flat.shapes == [s for _, s in want]
    assert flat.dim == DIMS[name] == make_flattener(params).dim


@pytest.mark.parametrize("name", [n for n in DIMS if n != "wideresnet40_4"])
def test_carried_weights_round_trip(name):
    model, params, tmodel, flat = _carry(name)
    params_np = jax.tree.map(np.asarray, params)
    w = from_jax_params(params_np)
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(make_flattener(params).ravel(params)))
    back = to_jax_params(w, tmodel)
    assert list(_paths(back)) == list(_paths(params_np))
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(params_np)):
        np.testing.assert_array_equal(got, want)


def test_wideresnet40_4_carry_round_trips():
    """The full WRN-40-4 (four levels of nesting, 8,972,340 entries)."""
    model, params, tmodel, flat = _carry("wideresnet40_4")
    params_np = jax.tree.map(np.asarray, params)
    w = from_jax_params(params_np)
    back = to_jax_params(w, tmodel)
    assert back["block3"]["b5"]["conv2"]["weight"].shape == (256, 256, 3, 3)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(params_np)):
        np.testing.assert_array_equal(got, want)


def _inputs(model, n, B, seed):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((n, B) + model.input_shape).astype(np.float32)
    ys = rng.integers(0, model.num_classes, (n, B)).astype(np.int32)
    return xs, ys


@pytest.mark.parametrize("name", [n for n in DIMS if n != "wideresnet40_4"])
def test_log_probs_match_jax(name):
    model, params, tmodel, flat = _carry(name)
    w = from_jax_params(jax.tree.map(np.asarray, params))
    x = _inputs(model, 1, 4, 0)[0][0]
    want = np.asarray(model.apply(params, jnp.asarray(x)))
    got = torch.func.functional_call(
        tmodel, flat.unflatten(w), (torch.from_numpy(x),)).detach().numpy()
    ref = torch.func.functional_call(
        tmodel, flat.unflatten(w.double()),
        (torch.from_numpy(x).double(),)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(want, ref, rtol=0, atol=1e-5)


def _rel_l2(a, ref):
    return np.linalg.norm(a - ref, axis=1) / np.linalg.norm(ref, axis=1)


# mnist_mlp's gradients are held in test_torch_port_model.py.  The BN
# models run at 2 images a client (tight band) and at 4 (kink band).
@pytest.mark.parametrize("name,B", [
    ("mnist_cnn", 4), ("cifar10_cnn", 4), ("resnet20", 2), ("resnet20", 4),
    (SHALLOW_WRN, 2), (SHALLOW_WRN, 4)])
def test_per_client_gradients_match_jax(name, B):
    model, params, tmodel, flat = _carry(name)
    n = 3
    xs, ys = _inputs(model, n, B, 0)
    jflat = make_flattener(params)
    want = np.asarray(jax_client_grad_fn(model, jflat)(
        jflat.ravel(params), jnp.asarray(xs), jnp.asarray(ys)))
    w = from_jax_params(jax.tree.map(np.asarray, params))
    grads = make_client_grad_fn(tmodel, flat)
    got = grads(w, torch.from_numpy(xs), torch.from_numpy(ys).long()).numpy()
    ref = grads(w.double(), torch.from_numpy(xs).double(),
                torch.from_numpy(ys).long()).numpy()
    assert got.shape == want.shape == (n, DIMS[name])
    band = KINK_BAND if (name in BATCH_STATS and B > 2) else TIGHT_BAND
    assert _rel_l2(got, ref).max() <= band
    assert _rel_l2(want, ref).max() <= band
    if band == TIGHT_BAND:
        assert _rel_l2(got, want.astype(np.float64)).max() <= 2 * band


def test_wideresnet40_4_log_probs_hold_fp64_across_relu_kinks():
    """The full WRN-40-4 at 2 images a client, as chip_smoke's deliver
    check runs it: each client's log-probs, BatchNorm over its own images
    under vmap, within 1e-5 of fp64 in relative L2, since they are
    continuous across a ReLU kink; its gradients, which are not, within
    the kink band."""
    _, params, tmodel, flat = _carry("wideresnet40_4")
    xs, ys = (torch.from_numpy(a) for a in _inputs(
        get_model("wideresnet40_4"), 2, 2, 0))
    ys = ys.long()
    w = from_jax_params(jax.tree.map(np.asarray, params))

    def log_probs(w_, x):
        p = flat.unflatten(w_)
        return torch.func.vmap(lambda xb: torch.func.functional_call(
            tmodel, p, (xb,)))(x).reshape(x.shape[0], -1).detach().numpy()

    lp_ref = log_probs(w.double(), xs.double())
    assert _rel_l2(log_probs(w, xs), lp_ref).max() <= TIGHT_BAND
    grads = make_client_grad_fn(tmodel, flat)
    ref = grads(w.double(), xs.double(), ys).numpy()
    assert _rel_l2(grads(w, xs, ys).numpy(), ref).max() <= KINK_BAND


def test_batch_norm_is_biased_batch_statistics(machine_threads):
    """Each client's statistics come from its own images: a client's
    gradient does not depend on what the other clients hold."""
    model, params, tmodel, flat = _carry(SHALLOW_WRN)
    w = from_jax_params(jax.tree.map(np.asarray, params))
    xs, ys = _inputs(model, 2, 3, 4)
    grads = make_client_grad_fn(tmodel, flat)
    both = grads(w, torch.from_numpy(xs), torch.from_numpy(ys).long())
    alone = grads(w, torch.from_numpy(xs[:1]), torch.from_numpy(ys[:1]).long())
    torch.testing.assert_close(both[:1], alone, rtol=0, atol=1e-7)
    assert not any(isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
                   for m in tmodel.modules())
    assert len(list(tmodel.buffers())) == 0


@pytest.mark.parametrize("name", ["resnet20", SHALLOW_WRN, "cifar10_cnn"])
def test_evaluation_matches_jax_with_a_short_last_batch(name):
    """37 test images in batches of 16: the last batch holds 11 images and
    5 zero rows, which enter BatchNorm's statistics in both packages."""
    model, params, tmodel, flat = _carry(name)
    rng = np.random.default_rng(9)
    tx = rng.standard_normal((37, 3, 32, 32)).astype(np.float32)
    ty = rng.integers(0, model.num_classes, 37).astype(np.int32)
    jflat = make_flattener(params)
    jl, jc = jax_make_eval_fn(model, jflat, tx, ty, 16)(jflat.ravel(params))
    w = from_jax_params(jax.tree.map(np.asarray, params))
    tl, tc = make_eval_fn(tmodel, flat, tx, ty, 16, "cpu")(w)
    assert int(tc) == int(jc)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


@pytest.mark.parametrize("name", [JC.SYNTH_CIFAR10, JC.SYNTH_CIFAR10_HARD,
                                  JC.CIFAR10, JC.CIFAR100])
def test_cifar_datasets_are_byte_identical(name, tmp_path):
    kw = dict(data_dir=str(tmp_path), seed=5, synth_train=300,
              synth_test=70)
    a = jds.load_dataset(name, **kw)
    b = tds.load_dataset(name, **kw)
    assert a.name == b.name and a.num_classes == b.num_classes
    for x, y in zip(a[1:5], b[1:5]):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def test_smooth_branch_leaves_the_mnist_sets_alone(tmp_path):
    """SYNTH_MNIST's bytes do not depend on the CIFAR branch: the same
    call with smooth_protos on a 1-channel 28x28 shape (28 is a multiple
    of 4, so the branch is taken) draws other prototypes."""
    plain = tds.make_synthetic((1, 28, 28), 10, 50, 10, 3, "s", 0.1, 0.3)
    want = jds.make_synthetic((1, 28, 28), 10, 50, 10, 3, "s", 0.1, 0.3)
    assert plain.train_x.tobytes() == want.train_x.tobytes()
    smooth = tds.make_synthetic((1, 28, 28), 10, 50, 10, 3, "s", 0.1, 0.3,
                                smooth_protos=True)
    assert smooth.train_x.tobytes() != plain.train_x.tobytes()


def _write_cifar(root, name, files, key_y, classes, rng):
    d = root / name
    d.mkdir()
    for f in files:
        batch = {b"data": rng.integers(0, 256, (20, 3072), dtype=np.uint8),
                 key_y: rng.integers(0, classes, 20).tolist()}
        with open(d / f, "wb") as fh:
            pickle.dump(batch, fh)


def test_cifar_pickle_loaders_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    _write_cifar(tmp_path, "cifar-10-batches-py",
                 [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"],
                 b"labels", 10, rng)
    _write_cifar(tmp_path, "cifar-100-python", ["train", "test"],
                 b"fine_labels", 100, rng)
    for name in (JC.CIFAR10, JC.CIFAR100):
        a = jds.load_dataset(name, data_dir=str(tmp_path))
        b = tds.load_dataset(name, data_dir=str(tmp_path))
        assert a.name == b.name == name and a.num_classes == b.num_classes
        assert b.train_x.shape[1:] == (3, 32, 32)
        for x, y in zip(a[1:5], b[1:5]):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_config_model_knobs_match_jax():
    assert C.FADING_RATES == JC.FADING_RATES
    assert C.MODEL_FAMILY == JC.MODEL_FAMILY
    assert C.DATASET_FAMILY == JC.DATASET_FAMILY
    parser = jcli.build_parser()
    choices = {a.dest: a.choices for a in parser._actions}
    assert tuple(choices["dataset"]) == C.DATASETS
    assert tuple(choices["model"]) == C.MODEL_NAMES
    for ds in C.DATASETS:
        assert C.default_model_for(ds) == JC.default_model_for(ds)
        a, b = JConfig(dataset=ds), ExperimentConfig(dataset=ds)
        assert (a.model, a.fading_rate) == (b.model, b.fading_rate)
    for model, ds in (("mnist_mlp", C.CIFAR10), ("resnet20", C.SYNTH_MNIST),
                      ("wideresnet40_4", C.MNIST)):
        with pytest.raises(ValueError) as je:
            JConfig(dataset=ds, model=model)
        with pytest.raises(ValueError) as te:
            ExperimentConfig(dataset=ds, model=model)
        assert str(te.value) == str(je.value)
    # A name outside the families is left to the model registry.
    assert ExperimentConfig(model=SHALLOW_WRN).model == SHALLOW_WRN


def test_config_accepts_remat_and_it_reaches_the_client_step(monkeypatch):
    """``remat=True`` is accepted, as the JAX config accepts it, and the
    engine hands it to the client step."""
    from attacking_federate_learning_tpu_torch.core import engine

    seen = []

    def spy(model, flat, local_steps=1, remat=False):
        seen.append(remat)
        return make_client_update_fn(model, flat, local_steps, remat)

    monkeypatch.setattr(engine, "make_client_update_fn", spy)
    for remat in (True, False):
        cfg = ExperimentConfig(dataset=C.SYNTH_MNIST, users_count=4,
                               mal_prop=0.0, remat=remat, synth_train=64,
                               synth_test=16)
        assert cfg.remat is JConfig(dataset=C.SYNTH_MNIST,
                                    remat=remat).remat is remat
        engine.FederatedExperiment(cfg, device="cpu")
    assert seen == [True, False]


def test_checkpoint_cannot_run_under_the_client_step():
    """Why the port has models/remat.py: torch.utils.checkpoint keeps its
    recompute in saved-tensor hooks, and inside vmap(grad(...)) those
    raise, so the client step checkpoints through an autograd.Function
    instead.  When PyTorch lifts the limit this test fails."""
    from torch.utils.checkpoint import checkpoint

    w = torch.ones(3)

    def loss(w, x):
        return checkpoint(lambda a, b: (a * b).sum(), w, x,
                          use_reentrant=False)

    with pytest.raises(RuntimeError, match="saved tensor hooks"):
        torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0))(
            w, torch.ones(2, 3))
