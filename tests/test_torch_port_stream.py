"""Host streaming (``data_placement='host_stream'``, data/stream.py): the
counterpart of each of the JAX package's tests/test_stream.py tests but
the sharded ones (they wait for the device mesh), on the CPU, where the
stream's gathers take the plain version (no staging, no copy).

A streamed run must be byte-equal to the same run with the training set
on the device, whatever the prefetch depth and worker count, with
participation, femnist_style and augmentation, across a preempt and
resume; and the port's streamed weights must agree with the JAX
package's streamed run within atol 1e-5 (tests/test_torch_port_round.py's
tolerance).
"""

import json
import os

import numpy as np
import pytest
import torch

from attacking_federate_learning_tpu import config as JC
from attacking_federate_learning_tpu.attacks import make_attacker
from attacking_federate_learning_tpu.config import ExperimentConfig as JConfig
from attacking_federate_learning_tpu.core.engine import (
    FederatedExperiment as JExperiment
)
from attacking_federate_learning_tpu.data.datasets import (
    load_dataset as jax_load_dataset
)
from attacking_federate_learning_tpu_torch import config as C
from attacking_federate_learning_tpu_torch.attacks import DriftAttack
from attacking_federate_learning_tpu_torch.config import ExperimentConfig
from attacking_federate_learning_tpu_torch.core.engine import (
    FederatedExperiment
)
from attacking_federate_learning_tpu_torch.core.server import (
    init_server_state
)
from attacking_federate_learning_tpu_torch.data.datasets import load_dataset
from attacking_federate_learning_tpu_torch.data.partition import (
    iid_shards, round_batch_indices
)
from attacking_federate_learning_tpu_torch.data.stream import HostStream
from attacking_federate_learning_tpu_torch.utils.checkpoint import (
    Checkpointer
)
from attacking_federate_learning_tpu_torch.utils.lifecycle import (
    GracefulShutdown, Preempted
)
from attacking_federate_learning_tpu_torch.utils.metrics import (
    RunLogger, validate_event
)
from attacking_federate_learning_tpu_torch.utils.weights import (
    from_jax_params
)

BASE = dict(dataset=C.SYNTH_MNIST, users_count=8, mal_prop=0.25,
            batch_size=16, defense="TrimmedMean", num_std=1.0,
            synth_train=512, synth_test=64)


def _engine(placement, rounds=3, **overrides):
    kw = dict(BASE, epochs=rounds, data_placement=placement)
    kw.update(overrides)
    cfg = ExperimentConfig(**kw)
    ds = load_dataset(cfg.dataset, seed=0, synth_train=kw["synth_train"],
                      synth_test=64)
    return FederatedExperiment(cfg, DriftAttack(cfg.num_std), ds,
                               device="cpu")


def _weights(placement, rounds=3, **overrides):
    exp = _engine(placement, rounds, **overrides)
    for t in range(rounds):
        exp.run_round(t)
    if exp.stream is not None:
        exp.stream.close()
    return exp.state.weights.numpy().copy(), exp.state.velocity.numpy().copy()


def _byte_equal(a, b):
    for x, y in zip(a, b):
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("kw", [
    dict(), dict(defense="Krum"), dict(defense="Bulyan", users_count=11,
                                       mal_prop=0.1),
    dict(defense="Median", local_steps=2),
    dict(users_count=8, participation=0.5, partition="femnist_style"),
    dict(stream_prefetch=2), dict(stream_workers=1),
    dict(stream_prefetch=3, stream_workers=1, participation=0.5)],
    ids=["trimmed_mean", "krum", "bulyan", "median-k2", "p0.5-femnist",
         "prefetch2", "worker", "deep-worker-p0.5"])
def test_streamed_equals_device_resident(kw):
    _byte_equal(_weights("host_stream", **kw), _weights("device", **kw))


def test_streamed_augmented_cifar_equals_device():
    kw = dict(dataset=C.SYNTH_CIFAR10, data_augment=True, users_count=4,
              batch_size=8, synth_train=256, defense="NoDefense",
              mal_prop=0.0)
    _byte_equal(_weights("host_stream", rounds=2, **kw),
                _weights("device", rounds=2, **kw))


def test_threaded_deep_prefetch_equals_inline():
    base = _weights("host_stream", rounds=4)
    deep = _weights("host_stream", rounds=4, stream_prefetch=3,
                    stream_workers=1)
    _byte_equal(base, deep)
    kw = dict(users_count=16, participation=0.5, rounds=4)
    _byte_equal(_weights("host_stream", **kw),
                _weights("host_stream", stream_prefetch=2, stream_workers=1,
                         **kw))


def test_host_stream_batches_match_device_gather():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((100, 3)).astype(np.float32)
    y = rng.integers(0, 5, 100).astype(np.int32)
    shards = iid_shards(100, 4, seed=1)
    stream = HostStream(x, y, shards, batch_size=8, device="cpu")
    for t in (0, 1, 5, 2):  # a backwards jump too (a resume)
        xs, ys = stream.get(t)
        idx = round_batch_indices(torch.from_numpy(shards), t, 8).numpy()
        np.testing.assert_array_equal(xs.numpy(), x[idx])
        np.testing.assert_array_equal(ys.numpy(), y[idx])
        assert ys.dtype == torch.int64


def test_host_stream_prefetch_cache_bounded():
    x = np.zeros((50, 2), np.float32)
    y = np.zeros(50, np.int32)
    stream = HostStream(x, y, iid_shards(50, 2, 0), batch_size=4,
                        device="cpu")
    for t in range(5):
        stream.get(t)
        assert set(stream._cache) == {t + 1}  # one slot in flight


def test_prefetch_horizon_stops_at_last_round():
    x = np.zeros((50, 2), np.float32)
    y = np.zeros(50, np.int32)
    stream = HostStream(x, y, iid_shards(50, 2, 0), batch_size=4,
                        device="cpu", n_rounds=3)
    for t in range(3):
        stream.get(t)
    assert stream._cache == {}


def test_deep_prefetch_cache_bound_and_order():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((60, 2)).astype(np.float32)
    y = rng.integers(0, 5, 60).astype(np.int32)
    shards = iid_shards(60, 3, 0)
    stream = HostStream(x, y, shards, batch_size=4, device="cpu",
                        prefetch=3, workers=1)
    try:
        for t in (0, 1, 2, 7, 3):     # jumps both ways
            xs, _ = stream.get(t)
            idx = round_batch_indices(torch.from_numpy(shards), t, 4)
            np.testing.assert_array_equal(xs.numpy(), x[idx.numpy()])
            assert set(stream._cache) <= {t + 1, t + 2, t + 3}
            assert len(stream._cache) == 3
    finally:
        stream.close()


def test_a_worker_s_error_reaches_get():
    x = np.zeros((20, 2), np.float32)
    y = np.zeros(20, np.int32)

    def cohort(t):
        if t == 2:
            raise KeyError("no cohort for round 2")
        return None

    stream = HostStream(x, y, iid_shards(20, 2, 0), batch_size=2,
                        device="cpu", participants_fn=cohort, workers=1)
    try:
        stream.get(0)
        stream.get(1)               # issues round 2 on the worker
        with pytest.raises(KeyError, match="no cohort for round 2"):
            stream.get(2)
    finally:
        stream.close()


def test_prefetch_draws_the_round_s_own_cohort():
    """participants_fn is called with the round it gathers, never
    another, and with prefetching on it sees each round once."""
    seen = []
    exp = _engine("host_stream", rounds=4, users_count=16,
                  participation=0.5, stream_prefetch=2)
    inner = exp.stream.participants_fn

    def spy(t):
        seen.append(t)
        return inner(t)

    exp.stream.participants_fn = spy
    for t in range(4):
        exp.run_round(t)
    assert sorted(seen) == [0, 1, 2, 3]
    ref = _engine("device", rounds=4, users_count=16, participation=0.5)
    for t in range(4):
        np.testing.assert_array_equal(spy(t), ref.participants(t))


def test_stall_stats_recorded(tmp_path):
    exp = _engine("host_stream", rounds=3, defense="NoDefense",
                  mal_prop=0.0, batch_size=8)
    with RunLogger(exp.cfg, None, str(tmp_path), jsonl_name="s") as logger:
        exp.run(logger)
    stats = exp.stream.stall_stats()
    assert stats["stream_gets"] == 3
    assert stats["stream_cold_misses"] == 1       # round 0 alone
    assert stats["stream_stall_s"] >= 0.0
    with open(os.path.join(str(tmp_path), "s.jsonl")) as fh:
        events = [json.loads(line) for line in fh]
    recs = [e for e in events if e["kind"] == "stream"]
    assert len(recs) == 1
    validate_event(recs[0])
    assert {k: recs[0][k] for k in stats} == stats


def test_streamed_preempt_resume_is_bit_for_bit(tmp_path):
    """A streamed run preempted at a boundary and resumed in a fresh
    engine (the stream starts cold at the resumed round) ends on the
    whole run's bytes, and on the device-placed run's."""
    kw = dict(epochs=10, test_step=5, checkpoint_every=3,
              run_dir=str(tmp_path / "runs"), log_dir=str(tmp_path / "l"),
              stream_prefetch=2, stream_workers=1, participation=0.5,
              users_count=16)
    whole = _engine("host_stream", **kw)
    whole.run(log=lambda s: None)
    device = _engine("device", **kw)
    device.run(log=lambda s: None)
    first = _engine("host_stream", **kw)
    ck = Checkpointer(first.cfg)
    with pytest.raises(Preempted) as e:
        first.run(log=lambda s: None, checkpointer=ck,
                  shutdown=GracefulShutdown(preempt_at_round=4))
    assert e.value.round == 5
    resumed = _engine("host_stream", **kw)
    state, extra = ck.resume(ck.latest(), with_extra=True, device="cpu")
    resumed.state = state
    resumed.restore_fault_state(extra)
    resumed.run(log=lambda s: None, checkpointer=ck)
    assert resumed.stream.cold_misses == 1
    for exp in (resumed, device):
        assert exp.state.weights.numpy().tobytes() == (
            whole.state.weights.numpy().tobytes())
        assert exp.state.velocity.numpy().tobytes() == (
            whole.state.velocity.numpy().tobytes())


@pytest.mark.parametrize("kw", [
    dict(), dict(participation=0.5, partition="femnist_style"),
    dict(defense="Krum", stream_prefetch=2, stream_workers=1)],
    ids=["trimmed_mean", "p0.5-femnist", "krum-worker"])
def test_streamed_weights_match_the_jax_package_s(kw):
    rounds = 3
    cfg = dict(BASE, epochs=rounds, data_placement="host_stream", **kw)
    jcfg = JConfig(**cfg, aggregation_impl="xla")
    jds = jax_load_dataset(JC.SYNTH_MNIST, seed=0, synth_train=512,
                           synth_test=64)
    jexp = JExperiment(jcfg, attacker=make_attacker(jcfg, dataset=jds),
                       dataset=jds)
    texp = _engine("host_stream", rounds=rounds, **kw)
    import jax
    texp.state = init_server_state(from_jax_params(jax.tree.map(
        np.asarray, jexp.flat.unravel(jexp.state.weights))))
    for t in range(rounds):
        jexp.run_round(t)
        texp.run_round(t)
    np.testing.assert_allclose(texp.state.weights.numpy(),
                               np.asarray(jexp.state.weights),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(texp.state.velocity.numpy(),
                               np.asarray(jexp.state.velocity),
                               rtol=0, atol=1e-5)
    assert texp.stream.gets == jexp.stream.gets == rounds


def test_invalid_placement_and_prefetch_rejected():
    with pytest.raises(ValueError, match="data_placement"):
        ExperimentConfig(dataset=C.SYNTH_MNIST, data_placement="hbm")
    with pytest.raises(ValueError, match="stream_prefetch"):
        ExperimentConfig(stream_prefetch=0)


@pytest.mark.parametrize("kw", [
    dict(aggregation="hierarchical", megabatch=4),
    dict(aggregation="async", async_buffer=6),
    dict(traffic=dict(population=64), defense="Krum")],
    ids=["hierarchical", "async", "traffic"])
def test_streaming_refusals_are_jax_s(kw):
    from attacking_federate_learning_tpu.config import (
        TrafficConfig as JTrafficConfig
    )
    from attacking_federate_learning_tpu_torch.config import TrafficConfig
    kw = dict(kw)
    traffic = kw.pop("traffic", None)
    cfg = dict(BASE, epochs=1, data_placement="host_stream", **kw)
    jds = jax_load_dataset(JC.SYNTH_MNIST, seed=0, synth_train=512,
                           synth_test=64)
    with pytest.raises(ValueError) as je:
        JExperiment(JConfig(**cfg, traffic=traffic and JTrafficConfig(
            **traffic)), dataset=jds)
    with pytest.raises(ValueError) as te:
        FederatedExperiment(ExperimentConfig(
            **cfg, traffic=traffic and TrafficConfig(**traffic)),
            device="cpu", dataset=load_dataset(C.SYNTH_MNIST, seed=0,
                                               synth_train=512,
                                               synth_test=64))
    assert str(te.value) == str(je.value)


def test_streamed_engine_keeps_no_training_set_on_the_device():
    exp = _engine("host_stream")
    assert exp.train_x is None and exp.train_y is None
    assert exp.shards.device.type == "cpu"
    assert isinstance(exp.stream, HostStream)
    assert _engine("device").stream is None
