"""The port's device mesh (parallel/) against the JAX package's.

On the CPU, positions are ``"cpu"`` devices and the JAX package runs on
the 8 virtual CPU devices of tests/conftest.py:

- ``pairwise_distances_allgather`` and ``pairwise_distances_ring`` over
  ``make_mesh((8, 1))`` against the JAX package's on its 8-device mesh,
  f32 and bf16, within atol 1e-4 (JAX's own test_parallel.py band), and
  against the port's distance kernel's plain version; an exact zero
  diagonal; ``cross_sq_distances`` against JAX's;
- the mesh: ``make_mesh``'s refusal is JAX's message, every position
  holds its own buffers, ``split_rows`` is ``torch.tensor_split``'s
  blocks, ``all_gather`` is position-major, ``ppermute`` zero-fills what
  nothing is sent to, the model axis is laid as JAX lays it;
- ``mesh_shape`` in the config and ``--mesh-shape`` in the CLI: JAX's
  validation messages, normalization, flag and parse;
- ``multihost``: a no-op on one process, half-set variables refused, a
  world-size-1 ``gloo`` group through a ``file://`` store, whose mesh
  is JAX's (tests/test_torch_port_processes.py runs two processes).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attacking_federate_learning_tpu import cli as jax_cli
from attacking_federate_learning_tpu.config import (
    ExperimentConfig as JConfig
)
from attacking_federate_learning_tpu.ops.distances import (
    cross_sq_distances as jax_cross_sq_distances
)
from attacking_federate_learning_tpu.parallel import distances as JPD
from attacking_federate_learning_tpu.parallel.mesh import (
    make_mesh as jax_make_mesh, make_plan as jax_make_plan
)
from attacking_federate_learning_tpu_torch import cli
from attacking_federate_learning_tpu_torch.config import ExperimentConfig
from attacking_federate_learning_tpu_torch.core.server import ServerState
from attacking_federate_learning_tpu_torch.ops.distances import (
    cross_sq_distances, pairwise_distances_plain
)
from attacking_federate_learning_tpu_torch.parallel import distances as PD
from attacking_federate_learning_tpu_torch.parallel import multihost
from attacking_federate_learning_tpu_torch.parallel.mesh import (
    CLIENTS, MODEL, make_mesh, make_plan
)

CPU = torch.device("cpu")
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _grads(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _as_bits_equal_inputs(G, dtype):
    """The same matrix in both packages: the bf16 rounding made once."""
    t = torch.from_numpy(G).to(DTYPES[dtype][0])
    return t, jnp.asarray(t.float().numpy()).astype(DTYPES[dtype][1])


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """The port on two intra-op threads, as in
    tests/test_torch_port_hierarchy.py; each comparison here is within a
    band."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the blockwise distances

@pytest.fixture(scope="module")
def jax_mesh():
    if len(jax.devices()) < 8:
        pytest.fail("the JAX package's mesh needs the 8 virtual devices of "
                    "tests/conftest.py")
    return jax_make_mesh((8, 1))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("impl", ["allgather", "ring"])
def test_blockwise_distances_are_jax_s(impl, dtype, jax_mesh):
    G = _grads(32, 200, seed=1)
    tg, jg = _as_bits_equal_inputs(G, dtype)
    fn = getattr(PD, f"pairwise_distances_{impl}")
    got = fn(tg, make_mesh((8, 1), [CPU] * 8))
    want = np.asarray(getattr(JPD, f"pairwise_distances_{impl}")(
        jg, jax_mesh))
    assert got.dtype == torch.float32 and got.shape == (32, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    np.testing.assert_allclose(got.numpy(),
                               pairwise_distances_plain(tg).numpy(),
                               atol=1e-4)
    assert torch.equal(torch.diagonal(got), torch.zeros(32))


@pytest.mark.parametrize("p", [1, 2, 4])
def test_ring_equals_allgather_at_every_axis_size(p):
    G = torch.from_numpy(_grads(16, 33, seed=p))
    mesh = make_mesh((p, 1), [CPU] * p)
    ring = PD.pairwise_distances_ring(G, mesh)
    ag = PD.pairwise_distances_allgather(G, mesh)
    np.testing.assert_allclose(ring.numpy(), ag.numpy(), atol=1e-5)


def test_blockwise_distances_need_even_blocks():
    with pytest.raises(ValueError, match=r"n=10, axis=4"):
        PD.pairwise_distances_ring(torch.zeros(10, 3),
                                   make_mesh((4, 1), [CPU] * 4))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cross_sq_distances_is_jax_s(dtype):
    A, B = _grads(7, 129, 2), _grads(5, 129, 3)
    ta, ja = _as_bits_equal_inputs(A, dtype)
    tb, jb = _as_bits_equal_inputs(B, dtype)
    got = cross_sq_distances(ta, tb)
    want = np.asarray(jax_cross_sq_distances(ja, jb))
    assert got.dtype == torch.float32 and got.shape == (7, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)


# ---------------------------------------------------------------------------
# the mesh and its collectives

def test_make_mesh_refuses_with_jax_s_message():
    with pytest.raises(ValueError) as te:
        make_mesh((4, 1), [CPU] * 2)
    with pytest.raises(ValueError) as je:
        jax_make_mesh((4, 1), jax.devices()[:2])
    assert str(te.value) == str(je.value)
    mesh = make_mesh((3, 1), [CPU] * 3)
    assert (mesh.shape[CLIENTS], mesh.shape[MODEL]) == (3, 1)
    assert mesh.shape == dict(jax_make_mesh((8, 1)).shape) | {CLIENTS: 3}


def test_the_card_is_the_default_and_none_is_refused_without_one():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(ValueError, match=r"mesh_shape \(4, 1\) != 0 "):
        make_plan((4, 1))
    with pytest.raises(ValueError, match="no CUDA device"):
        make_mesh()


def test_each_position_holds_its_own_buffers():
    plan = make_plan((4, 1), [CPU] * 4)
    x = torch.arange(12.0).reshape(6, 2)
    copies = plan.broadcast(x)
    assert len(copies) == 4
    assert len({c.data_ptr() for c in copies} | {x.data_ptr()}) == 5
    assert all(torch.equal(c, x) for c in copies)
    assert plan.broadcast(None) is None
    blocks = plan.split_rows(x)
    want = torch.tensor_split(x, 4)
    assert [b.shape[0] for b in blocks] == [2, 2, 1, 1]
    assert all(torch.equal(b, w) and b.data_ptr() != w.data_ptr()
               for b, w in zip(blocks, want))
    assert plan.row_bounds(6) == [(0, 2), (2, 4), (4, 5), (5, 6)]
    assert torch.equal(plan.all_gather(blocks), x)
    st = plan.place_state(ServerState(x[0], x[1], 3))
    assert torch.equal(st.weights, x[0]) and st.round == 3
    assert st.weights.data_ptr() != x[0].data_ptr()


def test_ppermute_is_lax_s_rule():
    plan = make_plan((3, 1), [CPU] * 3)
    blocks = [torch.full((2,), float(q + 1)) for q in range(3)]
    ring = plan.ppermute(blocks, [(0, 1), (1, 2), (2, 0)])
    assert [float(b[0]) for b in ring] == [3.0, 1.0, 2.0]
    partial = plan.ppermute(blocks, [(0, 2)])
    assert [float(b[0]) for b in partial] == [0.0, 0.0, 1.0]
    assert ring[1].data_ptr() != blocks[0].data_ptr()


@pytest.mark.parametrize("shape", [(1, 2), (2, 4)])
def test_the_model_axis_is_laid_as_jax_lays_it(shape):
    """Refused until the port ran the model axis: now the plan, the config
    and the split of d (79,510 splits at m = 2, not at 4) are JAX's."""
    c, m = shape
    plan = make_plan(shape, [CPU] * (c * m))
    jplan = jax_make_plan(shape, jax.devices()[:c * m])
    assert plan.mesh.shape == dict(jplan.mesh.shape)
    assert (plan.clients_parts, plan.model_parts) == shape
    assert plan.splits(79_510) == (jplan.weights_spec(79_510)[0] == MODEL)
    assert ExperimentConfig(mesh_shape=shape).mesh_shape == JConfig(
        mesh_shape=shape).mesh_shape == shape


# ---------------------------------------------------------------------------
# the config and the CLI

@pytest.mark.parametrize("bad", [(0, 1), (2,), (2, 1, 1), (2.0, 1),
                                 ("2", "1")])
def test_mesh_shape_messages_are_jax_s(bad):
    with pytest.raises(ValueError) as je:
        JConfig(mesh_shape=bad)
    with pytest.raises(ValueError) as te:
        ExperimentConfig(mesh_shape=bad)
    assert str(te.value) == str(je.value)


def test_mesh_shape_is_normalized_as_jax_s():
    t, j = ExperimentConfig(mesh_shape=[4, 1]), JConfig(mesh_shape=[4, 1])
    assert t.mesh_shape == j.mesh_shape == (4, 1)
    assert ExperimentConfig().mesh_shape is None is JConfig().mesh_shape
    again = ExperimentConfig(**dataclasses.asdict(t))
    assert again == t
    names = [f.name for f in dataclasses.fields(ExperimentConfig)]
    jnames = [f.name for f in dataclasses.fields(JConfig)]
    assert names.index("mesh_shape") == names.index("stream_workers") + 1
    assert "mesh_shape" in jnames


def _flag(parser):
    return [(a.option_strings, a.default, a.help, a.type)
            for a in parser._actions if a.dest == "mesh_shape"]


@pytest.mark.parametrize("argv", [[], ["--mesh-shape", "4,1"],
                                  ["--mesh-shape", "4,1", "--mesh-shape",
                                   "none"], ["--mesh-shape", "1,1"]])
def test_cli_flag_and_parse_are_jax_s(argv):
    assert _flag(cli.build_parser()) == _flag(jax_cli.build_parser())
    got = cli.config_from_args(cli.build_parser().parse_args(argv))
    want = jax_cli.config_from_args(jax_cli.build_parser().parse_args(argv))
    assert got.mesh_shape == want.mesh_shape


# ---------------------------------------------------------------------------
# multihost

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def test_initialize_is_a_no_op_on_one_process(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert multihost.initialize() is False
    assert not torch.distributed.is_initialized()
    assert multihost.is_primary()


def test_half_set_variables_are_refused(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="MASTER_PORT, RANK not set"):
        multihost.initialize()
    assert not torch.distributed.is_initialized()


def test_a_world_of_one_joins_through_a_file_store(tmp_path, monkeypatch):
    store = tmp_path / "store"
    try:
        assert multihost.initialize(init_method=f"file://{store}",
                                    world_size=1, rank=0,
                                    backend="gloo") is True
        assert torch.distributed.get_backend() == "gloo"
        assert multihost.is_primary()
        assert multihost.initialize() is True        # already joined
        x = torch.ones(3)
        torch.distributed.all_reduce(x)
        assert torch.equal(x, torch.ones(3))
        plan = make_plan((2, 1), [CPU] * 2)          # world size 1: fine
        assert plan.clients_parts == 2 and plan.group is None
        # A group of more than one process lays one mesh over every
        # process's positions (tests/test_torch_port_processes.py runs
        # two); its grid is JAX's over the same devices.
        jplan = jax_make_plan((2, 1), jax.devices()[:2])
        assert plan.mesh.shape == dict(jplan.mesh.shape)
        assert plan.is_primary and plan.processes == 1
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
