"""The port's checkpoints (utils/checkpoint.py): exact resume, and files
interchangeable with the JAX package's.

The JAX package's tests/test_checkpoint.py case by case on the port,
then: a port run interrupted by a preempt and resumed is bit for bit the
uninterrupted run; a checkpoint the JAX engine writes at round 4 (flat
Krum on its XLA path, faulted with stragglers, the ring in
``extra_stale``) resumes in the port, which runs on to round 8 and ends
within atol 1e-5 of the JAX engine's uninterrupted run
(test_torch_port_round.py's tolerance), and the same the other way
round; and the reference's ``checkpoint.pth.tar`` importer.
"""

import os

import jax
import numpy as np
import pytest
import torch

from attacking_federate_learning_tpu import config as JC
from attacking_federate_learning_tpu.attacks import DriftAttack as JDrift
from attacking_federate_learning_tpu.config import (
    ExperimentConfig as JConfig, FaultConfig as JFaultConfig
)
from attacking_federate_learning_tpu.core.engine import (
    FederatedExperiment as JExperiment
)
from attacking_federate_learning_tpu.data.datasets import (
    load_dataset as jax_load_dataset
)
from attacking_federate_learning_tpu.utils.checkpoint import (
    Checkpointer as JCheckpointer,
    import_reference_checkpoint as jax_import_reference
)
from attacking_federate_learning_tpu_torch import config as C
from attacking_federate_learning_tpu_torch.attacks import DriftAttack
from attacking_federate_learning_tpu_torch.config import (
    ExperimentConfig, FaultConfig
)
from attacking_federate_learning_tpu_torch.core.engine import (
    FederatedExperiment
)
from attacking_federate_learning_tpu_torch.core.server import (
    ServerState, init_server_state
)
from attacking_federate_learning_tpu_torch.data.datasets import load_dataset
from attacking_federate_learning_tpu_torch.models.base import get_model
from attacking_federate_learning_tpu_torch.utils.checkpoint import (
    Checkpointer, import_reference_checkpoint
)
from attacking_federate_learning_tpu_torch.utils.flatten import FlatParams
from attacking_federate_learning_tpu_torch.utils.lifecycle import (
    GracefulShutdown, Preempted, RunJournal
)
from attacking_federate_learning_tpu_torch.utils.weights import (
    from_jax_params
)


def cfg_for(tmp_path, **kw):
    base = dict(dataset=C.SYNTH_MNIST, users_count=8, batch_size=16,
                epochs=6, mal_prop=0.25, synth_train=256, synth_test=64,
                run_dir=str(tmp_path / "runs"),
                log_dir=str(tmp_path / "logs"))
    return ExperimentConfig(**{**base, **kw})


def engine(cfg):
    ds = load_dataset(cfg.dataset, seed=0, synth_train=cfg.synth_train,
                      synth_test=cfg.synth_test)
    return FederatedExperiment(cfg, DriftAttack(1.5), ds, device="cpu")


def st(r, d=4, w=0.0):
    return ServerState(weights=torch.full((d,), w), velocity=torch.zeros(d),
                       round=r)


def test_save_resume_roundtrip(tmp_path):
    cfg = cfg_for(tmp_path)
    exp = engine(cfg)
    for t in range(3):
        exp.run_round(t)
    ckpt = Checkpointer(cfg)
    path = ckpt.save(exp.state, accuracy=55.5)
    restored = ckpt.resume(path, device="cpu")
    assert torch.equal(restored.weights, exp.state.weights)
    assert torch.equal(restored.velocity, exp.state.velocity)
    assert restored.round == exp.state.round == 3
    assert isinstance(restored.round, int)
    # The JAX package's file layout: f32 (d,) vectors, a 0-d int32 round.
    with np.load(path) as z:
        assert z["weights"].dtype == z["velocity"].dtype == np.float32
        assert z["round"].dtype == np.int32 and z["round"].shape == ()
        assert z["accuracy"].dtype == np.float32
        assert z["weights"].shape == (exp.flat.dim,)


def test_atomic_save_leaves_no_temp_files(tmp_path):
    cfg = cfg_for(tmp_path)
    exp = engine(cfg)
    ckpt = Checkpointer(cfg)
    ckpt.save(exp.state, accuracy=10.0)
    ckpt.save_auto(exp.state, extra={"stale": np.zeros((2, 3), np.float32)})
    names = os.listdir(ckpt.dir)
    assert not any(".tmp" in n for n in names)
    assert "checkpoint.npz" in names and "checkpoint.json" in names
    assert any(n.startswith("checkpoint-auto-") for n in names)


def test_auto_rotation_keeps_last_n(tmp_path):
    cfg = cfg_for(tmp_path)
    ckpt = Checkpointer(cfg, keep_last=2)
    for r in range(5):
        ckpt.save_auto(st(r))
    autos = [n for n in os.listdir(ckpt.dir)
             if n.startswith("checkpoint-auto-") and n.endswith(".npz")]
    assert sorted(autos) == ["checkpoint-auto-00000003.npz",
                             "checkpoint-auto-00000004.npz"]
    jsons = [n for n in os.listdir(ckpt.dir)
             if n.startswith("checkpoint-auto-") and n.endswith(".json")]
    assert len(jsons) == 2
    assert ckpt.latest_auto().endswith("checkpoint-auto-00000004.npz")


def test_latest_picks_newest_by_round(tmp_path):
    cfg = cfg_for(tmp_path)
    ckpt = Checkpointer(cfg)
    ckpt.save(st(9), accuracy=80.0)       # best checkpoint at round 9
    ckpt.save_auto(st(4))
    assert ckpt.latest() == ckpt.path
    ckpt.save_auto(st(12))
    assert ckpt.latest().endswith("checkpoint-auto-00000012.npz")
    assert ckpt.load_best_acc() == 80.0
    # keep_best: a worse later state does not overwrite the best one.
    ckpt.save(st(13, w=1.0), accuracy=75.0)
    assert ckpt.load_best_acc() == 80.0


def test_latest_falls_back_to_the_shared_dir(tmp_path):
    """A journaled run's private auto dir with no auto yet: latest()
    takes the autos of the shared runs/<dataset>/ dir."""
    cfg = cfg_for(tmp_path)
    Checkpointer(cfg).save_auto(st(5))
    private = Checkpointer(cfg, auto_dir=str(tmp_path / "runs" / "r1"))
    assert private.latest().endswith(
        os.path.join(cfg.dataset, "checkpoint-auto-00000005.npz"))
    private.save_auto(st(2))
    assert private.latest().endswith(
        os.path.join("r1", "checkpoint-auto-00000002.npz"))


def test_resume_roundtrips_extra_state(tmp_path):
    cfg = cfg_for(tmp_path)
    ckpt = Checkpointer(cfg)
    buf = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    path = ckpt.save_auto(st(7, d=5, w=1.0), extra={"stale": buf})
    restored, extra = ckpt.resume(path, with_extra=True, device="cpu")
    assert restored.round == 7
    np.testing.assert_array_equal(extra["stale"], buf)
    assert ckpt.resume(path, device="cpu").round == 7


def test_resume_roundtrips_multi_array_extra(tmp_path):
    """Every array and dtype of a multi-array carry survives the npz
    round trip (the async rounds' buffers will ride this seam)."""
    cfg = cfg_for(tmp_path)
    ckpt = Checkpointer(cfg)
    rng = np.random.default_rng(0)
    extra_in = {
        "async_buf": rng.normal(size=(3, 4, 5)).astype(np.float32),
        "async_occ": rng.random((3, 4)) > 0.5,
        "async_birth": rng.integers(0, 9, (3, 4)).astype(np.int32),
        "async_pbuf": torch.randn(4, 5),
    }
    path = ckpt.save_auto(st(3, d=5), extra=extra_in)
    _, extra = ckpt.resume(path, with_extra=True, device="cpu")
    assert set(extra) == set(extra_in)
    for k, v in extra_in.items():
        v = v.numpy() if isinstance(v, torch.Tensor) else v
        assert extra[k].dtype == v.dtype, k
        np.testing.assert_array_equal(extra[k], v)


def test_resume_continues_bit_for_bit(tmp_path):
    cfg = cfg_for(tmp_path)
    full = engine(cfg)
    for t in range(6):
        full.run_round(t)
    first = engine(cfg)
    for t in range(3):
        first.run_round(t)
    ckpt = Checkpointer(cfg)
    ckpt.save(first.state, accuracy=0.0)
    second = engine(cfg)
    second.state = ckpt.resume(device="cpu")
    for t in range(3, 6):
        second.run_round(t)
    assert torch.equal(second.state.weights, full.state.weights)
    assert torch.equal(second.state.velocity, full.state.velocity)


def test_resume_puts_the_state_on_the_engine_s_device(tmp_path,
                                                      monkeypatch):
    """The tensors land on the device asked for, fresh copies; a CUDA
    device without CUDA raises instead of leaving them on the CPU."""
    cfg = cfg_for(tmp_path)
    ckpt = Checkpointer(cfg)
    path = ckpt.save_auto(st(2, w=3.0))
    s = ckpt.resume(path, device="cpu")
    assert s.weights.device.type == s.velocity.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ckpt.resume(path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ckpt.resume(path, device="cuda")


def test_run_interrupted_and_resumed_is_bit_equal(tmp_path):
    """Port-only resume through run(): faulted Krum with stragglers of
    delay 2, preempted at the first boundary past round 4, resumed from
    Checkpointer.latest() in a fresh engine (the ring from
    ``extra_stale``), ends bit for bit where the uninterrupted run
    ends."""
    fc = FaultConfig(dropout=0.1, straggler=0.2, straggler_delay=2)
    kw = dict(epochs=10, test_step=4, checkpoint_every=3, defense="Krum",
              faults=fc)
    full = engine(cfg_for(tmp_path / "a", **kw))
    want = full.run(log=lambda s: None)
    cfg = cfg_for(tmp_path / "b", **kw)
    first = engine(cfg)
    journal = RunJournal(cfg.run_dir, "resume")
    ckpt = Checkpointer(cfg, auto_dir=journal.dir)
    with pytest.raises(Preempted) as e:
        first.run(checkpointer=ckpt, journal=journal, log=lambda s: None,
                  shutdown=GracefulShutdown(preempt_at_round=4))
    assert e.value.round == 4          # boundaries 0, 3, 4, 6, 8, 9
    second = engine(cfg)
    state, extra = ckpt.resume(ckpt.latest(), with_extra=True,
                               device="cpu")
    assert state.round == 5 and extra["stale"].shape == (2, 8, 79510)
    second.state = state
    second.restore_carry_state(extra)
    got = second.run(checkpointer=ckpt, journal=RunJournal(cfg.run_dir,
                                                           "resume"),
                     log=lambda s: None)
    assert torch.equal(got["final_weights"], want["final_weights"])
    assert torch.equal(second.state.velocity, full.state.velocity)
    assert [r["round"] for r in want["faults"]] == list(range(10))
    assert got["faults"] == want["faults"][5:]
    assert got["accuracies"] == want["accuracies"][-2:]


def test_restore_carry_state_refuses_another_ring(tmp_path):
    exp = engine(cfg_for(tmp_path, faults=FaultConfig(straggler=0.2)))
    with pytest.raises(ValueError, match="straggler ring has shape"):
        exp.restore_carry_state({"stale": np.zeros((2, 8, 10), np.float32)})
    host = exp.carry_state_host()
    assert host["stale"].shape == (1, 8, exp.flat.dim)
    exp.restore_fault_state(host)
    assert exp.fault_state_host()["stale"].shape == host["stale"].shape


# ---------------------------------------------------------------------------
# interchangeable with the JAX package's checkpoints

N, MAL_PROP, B = 19, 0.22, 32
SIZES = dict(synth_train=1200, synth_test=300)
FAULTS = dict(dropout=0.1, straggler=0.2, straggler_delay=2)
KW = dict(dataset=C.SYNTH_MNIST_HARD, users_count=N, mal_prop=MAL_PROP,
          batch_size=B, epochs=8, defense="Krum", **SIZES)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX engine's uninterrupted eight rounds, with its own
    checkpoint at round 4 (JAX's Checkpointer, ring included)."""
    d = tmp_path_factory.mktemp("jaxrun")
    datasets = (jax_load_dataset(JC.SYNTH_MNIST_HARD, seed=0, **SIZES),
                load_dataset(C.SYNTH_MNIST_HARD, seed=0, **SIZES))
    jcfg = JConfig(**KW, aggregation_impl="xla",
                   faults=JFaultConfig(**FAULTS), run_dir=str(d))
    jexp = JExperiment(jcfg, attacker=JDrift(1.5), dataset=datasets[0])
    w0 = jax.tree.map(np.asarray, jexp.flat.unravel(jexp.state.weights))
    for t in range(8):
        jexp.run_round(t)
        if t == 3:
            path = JCheckpointer(jcfg).save_auto(
                jexp.state, extra=jexp.carry_state_host())
    return dict(cfg=jcfg, datasets=datasets, w0=w0, path=path,
                weights=np.array(jexp.state.weights, copy=True),
                velocity=np.array(jexp.state.velocity, copy=True))


def _port(datasets):
    return FederatedExperiment(
        ExperimentConfig(**KW, faults=FaultConfig(**FAULTS)),
        DriftAttack(1.5), datasets[1], device="cpu")


def test_jax_checkpoint_resumes_in_the_port(jax_run):
    texp = _port(jax_run["datasets"])
    state, extra = Checkpointer(texp.cfg, run_dir=os.path.dirname(
        jax_run["path"])).resume(jax_run["path"], with_extra=True,
                                 device="cpu")
    assert state.round == 4 and set(extra) == {"stale"}
    assert extra["stale"].shape == (2, N, texp.flat.dim)
    texp.state = state
    texp.restore_carry_state(extra)
    for t in range(4, 8):
        texp.run_round(t)
    # Same inputs and fp32 arithmetic in other summation orders
    # (test_torch_port_round.py's band).
    np.testing.assert_allclose(texp.state.weights.numpy(),
                               jax_run["weights"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(texp.state.velocity.numpy(),
                               jax_run["velocity"], rtol=0, atol=1e-5)


def test_port_checkpoint_resumes_in_jax(jax_run, tmp_path):
    texp = _port(jax_run["datasets"])
    texp.state = init_server_state(from_jax_params(jax_run["w0"]))
    for t in range(4):
        texp.run_round(t)
    ckpt = Checkpointer(texp.cfg, run_dir=str(tmp_path))
    path = ckpt.save_auto(texp.state, extra=texp.carry_state_host())
    jexp = JExperiment(jax_run["cfg"], attacker=JDrift(1.5),
                       dataset=jax_run["datasets"][0])
    state, extra = JCheckpointer(jax_run["cfg"], run_dir=str(
        tmp_path)).resume(path, with_extra=True)
    assert int(state.round) == 4 and state.round.dtype == np.int32
    jexp.state = state
    jexp.restore_fault_state(extra)
    for t in range(4, 8):
        jexp.run_round(t)
    np.testing.assert_allclose(np.asarray(jexp.state.weights),
                               jax_run["weights"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(jexp.state.velocity),
                               jax_run["velocity"], rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the reference's checkpoint.pth.tar

def _reference_state_dict(model, with_bn_buffers):
    """A torch state_dict in ``.parameters()`` order, with the buffers a
    reference BatchNorm2d writes after each BN layer's weight and bias."""
    sd = {}
    for name, p in model.named_parameters():
        sd[name] = p.detach().clone()
        if with_bn_buffers and name.endswith("bn1.bias"):
            stem = name[: -len("bias")]
            sd[stem + "running_mean"] = torch.zeros_like(p)
            sd[stem + "running_var"] = torch.ones_like(p)
            sd[stem + "num_batches_tracked"] = torch.tensor(7)
    return sd


@pytest.mark.parametrize("model,bn", [("mnist_mlp", False),
                                      ("resnet20", True)])
def test_import_reference_checkpoint(model, bn, tmp_path):
    net = get_model(model, torch.Generator().manual_seed(3))
    flat = FlatParams(net)
    sd = _reference_state_dict(net, bn)
    assert any(k.endswith("num_batches_tracked") for k in sd) == bn
    path = str(tmp_path / "checkpoint.pth.tar")
    torch.save({"epoch": 4, "state_dict": sd, "acc": 71.5}, path)
    state, acc = import_reference_checkpoint(path, expected_dim=flat.dim,
                                             device="cpu")
    assert acc == 71.5 and state.round == 4
    assert torch.equal(state.weights, flat.module_vector(net))
    assert torch.equal(state.velocity, torch.zeros(flat.dim))
    jstate, jacc = jax_import_reference(path, expected_dim=flat.dim)
    assert jacc == acc and int(jstate.round) == 4
    np.testing.assert_array_equal(np.asarray(jstate.weights),
                                  state.weights.numpy())
    with pytest.raises(ValueError, match="parameters, model expects"):
        import_reference_checkpoint(path, expected_dim=flat.dim + 1,
                                    device="cpu")
    # A bare state_dict: round 0, accuracy 0.
    torch.save(sd, path)
    state, acc = import_reference_checkpoint(path, device="cpu")
    assert (state.round, acc) == (0, 0.0)
