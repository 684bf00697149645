"""Experiment engine: the flat, synchronous FedSGD round.

The reference's round is four host-side phases over one process
(reference main.py:64-71).  Here a round is

    grads = vmap(grad(loss))(w, batches)      # deliver: all clients at once
    grads = attack.apply(grads, f)            # craft: first-f-rows overwrite
    agg   = defense(grads, n, f)              # tier-1 aggregate
    state = momentum_update(state, agg)       # apply

on one device.  Which implementation a defense runs follows the device
of the gradient matrix alone: on ``cuda`` Krum, TrimmedMean and Bulyan go
through the hand-written CUDA kernels (Krum through the fused distance ->
score kernel under its cancellation guard, the route the JAX engine takes
with ``aggregation_impl='pallas'``), on ``cpu`` the same calls take the
kernels' plain PyTorch versions.  No option selects the plain versions on
the card.

Evaluation runs on the host's cadence, every ``test_step`` rounds and
after the last one (reference main.py:73-95), and prints the reference's
``Test set:`` lines.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from attacking_federate_learning_tpu_torch.attacks.base import (
    Attack, NoAttack
)
from attacking_federate_learning_tpu_torch.config import ExperimentConfig
from attacking_federate_learning_tpu_torch.core.client import (
    make_client_grad_fn
)
from attacking_federate_learning_tpu_torch.core.evaluate import make_eval_fn
from attacking_federate_learning_tpu_torch.core.server import (
    ServerState, init_server_state, momentum_update
)
from attacking_federate_learning_tpu_torch.data.datasets import load_dataset
from attacking_federate_learning_tpu_torch.data.partition import (
    make_shards, round_batch_indices
)
from attacking_federate_learning_tpu_torch.defenses import (
    DEFENSES, check_defense_args
)
from attacking_federate_learning_tpu_torch.models.base import get_model
from attacking_federate_learning_tpu_torch.utils.flatten import FlatParams


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist.  There is
    no silent fallback to the CPU: the caller asks for it by name."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            f"pass device='cpu' to run the plain PyTorch versions on the "
            f"CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


class FederatedExperiment:
    """The flat FedSGD experiment of ``cfg`` on ``device`` (default
    ``cuda``).  ``dataset`` defaults to ``load_dataset`` of the config;
    ``attacker`` defaults to no attack."""

    def __init__(self, cfg: ExperimentConfig,
                 attacker: Optional[Attack] = None, dataset=None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.attacker = attacker or NoAttack()
        self.dataset = dataset or load_dataset(
            cfg.dataset, cfg.data_dir, cfg.seed,
            synth_train=cfg.synth_train, synth_test=cfg.synth_test)
        self.n = cfg.users_count
        self.f = cfg.corrupted_count
        check_defense_args(cfg.defense, self.n, self.f)

        defense = DEFENSES[cfg.defense]
        if cfg.defense == "Krum":
            # The fused distance -> score kernel under the cancellation
            # guard, exact sort over the distance kernel when it fails.
            defense = functools.partial(
                defense, method="fused",
                paper_scoring=cfg.krum_paper_scoring)
        elif cfg.defense == "Bulyan" and cfg.krum_paper_scoring:
            defense = functools.partial(defense, paper_scoring=True)
        self.defense_fn = defense

        gen = torch.Generator().manual_seed(cfg.seed)
        self.model = get_model(cfg.model, gen).to(self.device)
        self.flat = FlatParams(self.model)
        self.state = init_server_state(self.flat.module_vector(self.model))

        shards = make_shards(cfg.partition, self.dataset.train_y, self.n,
                             cfg.seed, cfg.dirichlet_alpha)
        self.shards = torch.from_numpy(shards).to(self.device, torch.int64)
        self.train_x = torch.from_numpy(self.dataset.train_x).to(self.device)
        self.train_y = torch.from_numpy(self.dataset.train_y).to(
            self.device, torch.int64)
        self._client_grads = make_client_grad_fn(self.model, self.flat)
        self.evaluate = make_eval_fn(self.model, self.flat,
                                     self.dataset.test_x,
                                     self.dataset.test_y, cfg.batch_size,
                                     self.device)

    def gather_batches(self, t: int):
        """Round-t minibatches of every client: one (n, B) gather from
        the device-resident training set."""
        idx = round_batch_indices(self.shards, t, self.cfg.batch_size)
        return self.train_x[idx], self.train_y[idx]

    def compute_grads(self, t: int) -> torch.Tensor:
        """deliver: the (n, d) per-client gradients at the server weights
        of round t."""
        xs, ys = self.gather_batches(t)
        return self._client_grads(self.state.weights, xs, ys).contiguous()

    def run_round(self, t: int) -> ServerState:
        cfg = self.cfg
        grads = self.compute_grads(t)
        grads = self.attacker.apply(grads, self.f)             # craft
        agg = self.defense_fn(grads, self.n, self.f)           # aggregate
        self.state = momentum_update(self.state, agg, cfg.learning_rate,
                                     cfg.momentum)             # apply
        return self.state

    def run(self, log: Callable[[str], None] = print) -> dict:
        """Full experiment loop (reference main.py:64-95): ``cfg.epochs``
        rounds, evaluated every ``test_step`` rounds and after the last,
        each evaluation reported as the reference's ``Test set:`` line
        through ``log``."""
        cfg = self.cfg
        test_size = len(self.dataset.test_y)
        accuracies, epochs = [], []
        log("\nStarting Training...")
        for epoch in range(int(self.state.round), cfg.epochs):
            self.run_round(epoch)
            if epoch % cfg.test_step == 0 or epoch == cfg.epochs - 1:
                test_loss, correct = self.evaluate(self.state.weights)
                accuracy = 100.0 * float(correct) / test_size
                accuracies.append(accuracy)
                epochs.append(epoch)
                log("Test set: [{:3d}] Average loss: {:.4f}, "
                    "Accuracy: {}/{} ({:.2f}%)".format(
                        epoch, float(test_loss), int(correct), test_size,
                        accuracy))
        if accuracies:
            log("Max accuracy: {}".format(max(accuracies)))
        return {"accuracies": accuracies, "epochs": epochs,
                "final_weights": self.state.weights}
