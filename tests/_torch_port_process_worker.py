"""One process of the two-process mesh exercise (test_torch_port_processes).

Each process holds four CPU positions of one (8, 1) mesh laid over a
``torch.distributed`` group joined through a ``file://`` store with
``gloo``.  The ring and allgather distances cross the process boundary
(the ring's visiting blocks by isend / irecv), Krum runs on them, and a
flat round runs with each process delivering its positions' rows and the
primary process aggregating, applying and broadcasting the state, by
``run_round`` and by ``run()`` (a clean run, and the watchdog's rollback
to an auto-checkpoint boundary).  The primary process also runs the same
work in one process before it joins (the references).  Results go to
``<out>.<rank>.npz``.

Usage: python _torch_port_process_worker.py <store> <world> <rank> <out>
"""

import os
import sys

import numpy as np
import torch

N, D_COLS, F = 16, 256, 3
ROUNDS = 2
RUN_EPOCHS = 3
# test_torch_port_lifecycle's watchdog case: the scale corruption hits
# round 5 alone, the boundary of round 4 saves a good state first, and
# the divergence seen at round 6 rolls back to round counter 5.
WATCHDOG = dict(corrupt=0.02, corrupt_mode="scale", corrupt_scale=1e30,
                watchdog_norm=1e6, max_rollbacks=1, seed=2)


def flat_round(plan):
    from attacking_federate_learning_tpu_torch.attacks.alie import (
        DriftAttack
    )
    from attacking_federate_learning_tpu_torch.config import (
        ExperimentConfig
    )
    from attacking_federate_learning_tpu_torch.core.engine import (
        FederatedExperiment
    )
    from attacking_federate_learning_tpu_torch.data.datasets import (
        load_dataset
    )

    cfg = ExperimentConfig(dataset="SYNTH_MNIST", users_count=16,
                           mal_prop=0.25, batch_size=8, epochs=ROUNDS,
                           defense="Krum")
    ds = load_dataset(cfg.dataset, seed=0, synth_train=256, synth_test=64)
    exp = FederatedExperiment(cfg, DriftAttack(cfg.num_std), ds,
                              device="cpu", shardings=plan)
    for t in range(ROUNDS):
        exp.run_round(t)
    return exp.state.weights.numpy().copy()


def runs(plan):
    """``run()`` over ``plan``: RUN_EPOCHS clean Krum rounds, and the
    watchdog's rollback, which ends in FloatingPointError past
    max_rollbacks.  Each gives its round counter and weights."""
    from attacking_federate_learning_tpu_torch.attacks.alie import (
        DriftAttack
    )
    from attacking_federate_learning_tpu_torch.config import (
        ExperimentConfig, FaultConfig
    )
    from attacking_federate_learning_tpu_torch.core.engine import (
        FederatedExperiment
    )
    from attacking_federate_learning_tpu_torch.data.datasets import (
        load_dataset
    )

    out = {}
    cfg = ExperimentConfig(dataset="SYNTH_MNIST", users_count=16,
                           mal_prop=0.25, batch_size=8, epochs=RUN_EPOCHS,
                           test_step=2, defense="Krum")
    ds = load_dataset(cfg.dataset, seed=0, synth_train=256, synth_test=64)
    exp = FederatedExperiment(cfg, DriftAttack(cfg.num_std), ds,
                              device="cpu", shardings=plan)
    res = exp.run(log=lambda s: None)
    out["run_round"] = np.int64(exp.state.round)
    out["run_epochs"] = np.asarray(res["epochs"])
    out["run_weights"] = exp.state.weights.numpy().copy()

    cfg = ExperimentConfig(dataset="SYNTH_MNIST", users_count=10,
                           mal_prop=0.0, batch_size=16, epochs=8,
                           test_step=2, checkpoint_every=2,
                           defense="NoDefense",
                           faults=FaultConfig(**WATCHDOG))
    exp = FederatedExperiment(cfg, DriftAttack(0.0), ds, device="cpu",
                              shardings=plan)
    lines = []
    try:
        exp.run(log=lines.append)
        out["wd_error"] = np.str_("")
    except FloatingPointError as e:
        out["wd_error"] = np.str_(str(e))
    out["wd_lines"] = np.asarray(
        [s for s in lines if s.startswith("!! server state")] or [""])
    out["wd_round"] = np.int64(exp.state.round)
    out["wd_weights"] = exp.state.weights.numpy().copy()
    return out


def blockwise(plan, G):
    from attacking_federate_learning_tpu_torch.defenses.kernels import krum
    from attacking_federate_learning_tpu_torch.parallel import (
        distances as PD
    )

    out = {}
    for name, fn in (("ring", PD.pairwise_distances_ring),
                     ("allgather", PD.pairwise_distances_allgather)):
        D = fn(G, plan)
        if D is not None:
            out[f"D_{name}"] = D.numpy()
            out[f"krum_{name}"] = krum(G, N, F, D=D).numpy()
    return out


def main():
    store, world, rank, out = (sys.argv[1], int(sys.argv[2]),
                               int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    from attacking_federate_learning_tpu_torch.parallel import multihost
    from attacking_federate_learning_tpu_torch.parallel.mesh import (
        make_plan
    )

    cpu = [torch.device("cpu")] * 4
    G = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (N, D_COLS)).astype(np.float32))
    res = {}
    if rank == 0:
        one = make_plan((4 * world, 1), cpu * world)
        res.update({f"one_{k}": v for k, v in blockwise(one, G).items()})
        res["one_weights"] = flat_round(one)
        res.update({f"one_{k}": v for k, v in runs(one).items()})
    assert multihost.initialize(init_method=f"file://{store}",
                                world_size=world, rank=rank,
                                backend="gloo") is True
    assert multihost.is_primary() == (rank == 0)
    plan = make_plan((4 * world, 1), cpu)
    assert plan.processes == world and plan.clients_parts == 4 * world
    res.update(blockwise(plan, G))
    res["weights"] = flat_round(plan)
    res.update(runs(plan))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    np.savez(f"{out}.{rank}.npz", G=G.numpy(), **res)
    print("WORKER_OK", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
