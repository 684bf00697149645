"""A mesh over the processes of a ``torch.distributed`` group
(parallel/mesh.py, parallel/multihost.py) against the one-process mesh
and the JAX package's Krum.

Two child processes (tests/_torch_port_process_worker.py) join one
``gloo`` group through a ``file://`` store (no ports to race), four CPU
positions each, and lay one (8, 1) mesh over both:

- the ring and allgather distances cross the process boundary and equal
  the one-process schedules bit for bit, and Krum on them equals the
  one-process kernel's and the JAX package's ``krum`` on the same G
  (atol 1e-5);
- two flat rounds, each process delivering its positions' rows and the
  primary process aggregating, applying and broadcasting the state,
  equal the one-process (8, 1) round bit for bit, on both processes;
- ``run()`` over the processes: a clean run, and the watchdog's rollback
  to an auto-checkpoint boundary, end at the same round counter and the
  same weights on both processes as in one process.

Each child has its own timeout; a wrong answer, a failed child or a hung
one fails the test.  The refusals of a process mesh (the model axis, the
rounds that would need the group inside them) are checked in this
process on a plan that names a group.
"""

import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attacking_federate_learning_tpu.defenses.kernels import (
    krum as jax_krum
)
from attacking_federate_learning_tpu_torch.attacks import DriftAttack
from attacking_federate_learning_tpu_torch.config import ExperimentConfig
from attacking_federate_learning_tpu_torch.core.engine import (
    FederatedExperiment
)
from attacking_federate_learning_tpu_torch.data.datasets import load_dataset
from attacking_federate_learning_tpu_torch.defenses.kernels import krum
from attacking_federate_learning_tpu_torch.ops.distances import (
    pairwise_distances_plain
)
from attacking_federate_learning_tpu_torch.parallel.mesh import (
    MeshPlan, make_mesh
)

WORKER = pathlib.Path(__file__).parent / "_torch_port_process_worker.py"
WORLD = 2
CHILD_TIMEOUT = 120            # seconds, each child
N, F = 16, 3                   # the worker's G and f


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Both children's results, after both exited 0 within their
    timeouts."""
    tmp = tmp_path_factory.mktemp("procs")
    out = tmp / "result"
    root = WORKER.parent.parent
    env = {**os.environ,
           "PYTHONPATH": f"{root}:{os.environ.get('PYTHONPATH', '')}"}
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(tmp / "store"), str(WORLD),
         str(r), str(out)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=str(root))
        for r in range(WORLD)]
    logs, hung = [], []
    for r, p in enumerate(procs):
        try:
            logs.append(p.communicate(timeout=CHILD_TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            hung.append(r)
            p.kill()
            logs.append(p.communicate()[0])
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert not hung, f"rank(s) {hung} hung past {CHILD_TIMEOUT} s:\n" + \
        "\n".join(logs)
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and "WORKER_OK" in log, (
            f"rank {r} exited {p.returncode}:\n{log}")
    return [dict(np.load(f"{out}.{r}.npz")) for r in range(WORLD)]


@pytest.mark.parametrize("schedule", ["ring", "allgather"])
def test_distances_across_processes_are_the_one_process_schedule(
        schedule, results):
    primary, other = results
    got = primary[f"D_{schedule}"]
    assert np.array_equal(got, primary[f"one_D_{schedule}"])
    assert f"D_{schedule}" not in other          # gathered to the primary
    want = pairwise_distances_plain(torch.from_numpy(primary["G"]))
    np.testing.assert_allclose(got, want.numpy(), atol=1e-4)
    assert not np.diagonal(got).any()


@pytest.mark.parametrize("schedule", ["ring", "allgather"])
def test_krum_across_processes_is_the_kernel_s_and_jax_s(schedule, results):
    primary = results[0]
    G = primary["G"]
    got = primary[f"krum_{schedule}"]
    assert np.array_equal(got, primary[f"one_krum_{schedule}"])
    kernel = krum(torch.from_numpy(G), N, F).numpy()
    np.testing.assert_allclose(got, kernel, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jax_krum(jnp.asarray(G), N,
                                                        F)), atol=1e-5)


def test_flat_rounds_across_processes_are_the_one_process_round(results):
    primary, other = results
    assert np.array_equal(primary["weights"], primary["one_weights"])
    assert np.array_equal(other["weights"], primary["weights"])


def test_a_clean_run_keeps_the_round_counter_on_every_process(results):
    primary, other = results
    for r in (primary, other):
        assert int(r["run_round"]) == 3
        assert r["run_epochs"].tolist() == [0, 2]
        assert np.array_equal(r["run_weights"], primary["one_run_weights"])
    assert int(primary["one_run_round"]) == 3


def test_the_watchdog_rolls_back_in_step_on_every_process(results):
    """Divergence after round 5 rolls back to round counter 5 (the
    auto-checkpoint of round 4's boundary) on both processes, which raise
    together past max_rollbacks, each holding the one-process state."""
    primary, other = results
    want = ["!! server state diverged after round 6; rolling back to "
            f"round 5 (rollback {i}/1)" for i in (1, 2)]
    assert primary["one_wd_lines"].tolist() == want
    for r in (primary, other):
        assert "exhausted 1 rollbacks" in str(r["wd_error"])
        assert r["wd_lines"].tolist() == want
        assert int(r["wd_round"]) == 5
        assert np.array_equal(r["wd_weights"], primary["one_wd_weights"])


def _group_plan(shape):
    mesh = make_mesh(shape, ["cpu"] * (shape[0] * shape[1]))
    return MeshPlan(mesh, group={"rank": 0, "world": 2,
                                 "ends": np.array([shape[0] // 2,
                                                   shape[0]])})


def test_the_model_axis_across_processes_is_refused():
    with pytest.raises(ValueError, match="model axis across processes"):
        _group_plan((4, 2))


@pytest.mark.parametrize("kw,word", [
    (dict(aggregation="hierarchical", megabatch=4), "hierarchical round"),
    (dict(aggregation="async", async_buffer=4), "async buffered round"),
    (dict(data_placement="host_stream"), "host_stream"),
    (dict(defense="Krum", distance_impl="ring"), "distance_impl='ring'"),
])
def test_what_a_process_mesh_does_not_run_is_refused_by_name(kw, word):
    cfg = ExperimentConfig(**{**dict(
        dataset="SYNTH_MNIST", users_count=16, mal_prop=0.25,
        batch_size=8, epochs=1, synth_train=256, synth_test=64), **kw})
    ds = load_dataset("SYNTH_MNIST", seed=0, synth_train=256, synth_test=64)
    with pytest.raises(ValueError, match="a mesh over 2 processes") as e:
        FederatedExperiment(cfg, DriftAttack(1.0), ds, device="cpu",
                            shardings=_group_plan((4, 1)))
    assert word in str(e.value)
