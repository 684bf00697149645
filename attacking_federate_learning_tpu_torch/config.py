"""Experiment configuration of the flat FedSGD round.

A flat-only subset of the JAX package's ``ExperimentConfig``: the fields
the flat, synchronous, full-participation round reads, with the same
defaults, the same derived values (``corrupted_count``, ``'auto'`` z,
per-dataset fading rate, default model) and the same validation
messages.  Hierarchical/async aggregation, faults, traffic, secagg,
backdoor and the observability knobs are later slices of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


MNIST = "MNIST"
SYNTH_MNIST = "SYNTH_MNIST"            # MNIST-shaped deterministic synthetic
SYNTH_MNIST_HARD = "SYNTH_MNIST_HARD"  # low-SNR variant for behavioral tests

DATASETS = (MNIST, SYNTH_MNIST, SYNTH_MNIST_HARD)

# Per-dataset LR fading constants (reference main.py:144-149).
FADING_RATES = {MNIST: 10000.0, SYNTH_MNIST: 10000.0,
                SYNTH_MNIST_HARD: 10000.0}

DEFENSE_NAMES = ("NoDefense", "Krum", "TrimmedMean", "Bulyan")


@dataclasses.dataclass
class ExperimentConfig:
    # --- topology -------------------------------------------------------
    users_count: int = 10            # reference main.py:118
    mal_prop: float = 0.24           # reference main.py:106
    dataset: str = MNIST             # reference main.py:114
    model: Optional[str] = None      # default: dataset's canonical model

    # --- optimization ---------------------------------------------------
    learning_rate: float = 0.1       # server base lr, reference main.py:127
    fading_rate: Optional[float] = None  # None -> FADING_RATES[dataset]
    momentum: float = 0.9            # reference main.py:138
    batch_size: int = 128            # reference main.py:121
    epochs: int = 300                # rounds, reference main.py:124

    # --- attack ---------------------------------------------------------
    # ALIE z (reference main.py:109); 'auto' resolves at construction
    # to the ALIE paper's z_max (attacks/alie.py:paper_z).
    num_std: "float | str" = 1.5

    # --- defense --------------------------------------------------------
    defense: str = "NoDefense"       # reference main.py:112
    # Krum scores sum the n-f smallest distances (reference
    # defences.py:26) unless this selects the paper's n-f-2.
    krum_paper_scoring: bool = False

    # --- evaluation -----------------------------------------------------
    test_step: int = 5               # reference main.py:58
    data_dir: str = "data"           # raw MNIST idx location

    # --- determinism and data -------------------------------------------
    seed: int = 0
    synth_train: int = 10000
    synth_test: int = 2000
    partition: str = "iid"           # 'iid' | 'dirichlet'
    dirichlet_alpha: float = 0.5

    def __post_init__(self):
        if self.dataset not in DATASETS:
            raise ValueError(f"Unknown dataset {self.dataset!r}")
        if self.model is not None and self.model != "mnist_mlp":
            raise ValueError(
                f"model {self.model!r} is not ported yet (mnist_mlp only)")
        if self.defense not in DEFENSE_NAMES:
            raise ValueError(
                f"defense must be one of {DEFENSE_NAMES}, "
                f"got {self.defense!r}")
        if self.partition not in ("iid", "dirichlet"):
            raise ValueError(f"Unknown partition {self.partition!r}")
        if self.num_std == "auto":
            from attacking_federate_learning_tpu_torch.attacks.alie import (
                paper_z
            )
            self.num_std = paper_z(self.users_count, self.corrupted_count)
        elif (isinstance(self.num_std, bool)
                or not isinstance(self.num_std, (int, float))):
            # bool is an int subclass; num_std=True silently meaning
            # z=1.0 would be a config typo accepted as physics.
            raise ValueError(
                f"num_std must be a number or 'auto', got "
                f"{self.num_std!r}")
        if self.fading_rate is None:
            self.fading_rate = FADING_RATES.get(self.dataset, 10000.0)
        if self.model is None:
            self.model = "mnist_mlp"

    @property
    def corrupted_count(self) -> int:
        # reference main.py:21 / server.py:87
        return int(self.mal_prop * self.users_count)
