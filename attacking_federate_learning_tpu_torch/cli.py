"""Experiment CLI of the flat FedSGD round.

The flat flags of the JAX package's CLI, with the reference driver's
short flags and defaults (-m 0.24, -z 1.5, -d NoDefense, -s MNIST, -b No,
-e 300), the ``--fault-*`` flags of the fault model, plus ``--device``.  It prints the same ``Test set: [ N] ...
Accuracy: x/N`` lines.  The run is on the card unless ``--device cpu``
asks for the CPU.  Backdoor attacks are not ported yet, so ``-b`` takes
only ``No``.

Run:  python -m attacking_federate_learning_tpu_torch.cli -s SYNTH_MNIST \\
          -d Krum -n 100 -m 0.24
      python -m attacking_federate_learning_tpu_torch.cli -s SYNTH_MNIST \\
          -d Median -n 100 -m 0.1 --fault-dropout 0.1 --fault-straggler 0.1
"""

from __future__ import annotations

import argparse

from attacking_federate_learning_tpu_torch import config as C
from attacking_federate_learning_tpu_torch.config import ExperimentConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Federated-learning attack/defense simulator "
                    "(PyTorch/CUDA port, flat FedSGD round)")
    p.add_argument("-s", "--dataset", default=C.MNIST, choices=C.DATASETS)
    p.add_argument("-d", "--defense", default="NoDefense",
                   choices=C.DEFENSE_NAMES)
    p.add_argument("-n", "-dispatch_weightsn", "--users-count", default=10,
                   type=int)
    p.add_argument("-m", "--mal-prop", default=0.24, type=float,
                   help="proportion of malicious users")
    p.add_argument("-z", "--num_std", default=1.5,
                   type=lambda s: s if s == "auto" else float(s),
                   help="how many standard deviations the ALIE attacker "
                        "shifts; 'auto' computes the ALIE paper's z_max "
                        "from (n, f)")
    p.add_argument("-e", "--epochs", default=300, type=int)
    p.add_argument("-b", "--backdoor", default="No", choices=["No"],
                   help="backdoor attacks are not ported yet")
    p.add_argument("-c", "--batch-size", "--batch_size", dest="batch_size",
                   default=128, type=int)
    p.add_argument("-l", "--learning_rate", default=0.1, type=float)
    p.add_argument("--synth-train", default=ExperimentConfig.synth_train,
                   type=int,
                   help="training examples for SYNTH_* / fallback datasets")
    p.add_argument("--synth-test", default=ExperimentConfig.synth_test,
                   type=int,
                   help="test examples for SYNTH_* / fallback datasets")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--test-step", default=ExperimentConfig.test_step,
                   type=int, help="evaluate every this many rounds")
    p.add_argument("--data-dir", default="data", type=str)
    p.add_argument("--fault-dropout", default=0.0, type=float,
                   metavar="P",
                   help="per-client per-round dropout probability: the "
                        "client returns no update; its row is "
                        "quarantined out of the aggregation "
                        "(core/faults.py)")
    p.add_argument("--fault-straggler", default=0.0, type=float,
                   metavar="P",
                   help="per-client per-round straggler probability: the "
                        "client submits its gradient from "
                        "--fault-straggler-delay rounds ago (stale ring "
                        "buffer on the device)")
    p.add_argument("--fault-straggler-delay", default=1, type=int,
                   metavar="K", help="straggler staleness in rounds")
    p.add_argument("--fault-corrupt", default=0.0, type=float,
                   metavar="P",
                   help="per-HONEST-client per-round corruption "
                        "probability (distinct from the attack seam, "
                        "which owns rows [0, f)); see "
                        "--fault-corrupt-mode")
    p.add_argument("--fault-corrupt-mode", default="nan",
                   choices=["nan", "inf", "scale"],
                   help="corruption flavor: non-finite rows ('nan'/'inf' "
                        "— caught by the pre-aggregation quarantine) or "
                        "finite bit-scaled rows ('scale' — what the "
                        "robust defense / divergence watchdog must "
                        "absorb)")
    p.add_argument("--fault-shard-dropout", default=0.0, type=float,
                   metavar="P",
                   help="per-SHARD-DOMAIN per-round failure onset "
                        "probability (hierarchical aggregation only, "
                        "which the port does not have yet: refused)")
    p.add_argument("--fault-shard-dropout-dwell", default=1, type=int,
                   metavar="K",
                   help="rounds a dead shard domain stays dead after "
                        "each failure onset (correlated outage width)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the card (default), or the CPU with the kernels' "
                        "plain PyTorch versions")
    return p


def config_from_args(args) -> ExperimentConfig:
    faults = None
    if (args.fault_dropout or args.fault_straggler or args.fault_corrupt
            or args.fault_shard_dropout):
        faults = C.FaultConfig(
            dropout=args.fault_dropout,
            straggler=args.fault_straggler,
            corrupt=args.fault_corrupt,
            straggler_delay=args.fault_straggler_delay,
            corrupt_mode=args.fault_corrupt_mode,
            shard_dropout=args.fault_shard_dropout,
            shard_dropout_dwell=args.fault_shard_dropout_dwell)
    return ExperimentConfig(
        users_count=args.users_count, mal_prop=args.mal_prop,
        dataset=args.dataset, learning_rate=args.learning_rate,
        batch_size=args.batch_size, epochs=args.epochs,
        num_std=args.num_std, defense=args.defense, test_step=args.test_step,
        data_dir=args.data_dir, seed=args.seed,
        synth_train=args.synth_train, synth_test=args.synth_test,
        faults=faults)


def main(argv=None) -> dict:
    from attacking_federate_learning_tpu_torch.attacks import DriftAttack
    from attacking_federate_learning_tpu_torch.core.engine import (
        FederatedExperiment
    )

    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    print(cfg)
    exp = FederatedExperiment(cfg, attacker=DriftAttack(cfg.num_std),
                              device=args.device)
    return exp.run()


if __name__ == "__main__":
    main()
