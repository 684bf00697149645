"""Experiment engine: the flat, synchronous FedSGD round.

The reference's round is four host-side phases over one process
(reference main.py:64-71).  Here a round is

    part  = participants(t)                   # the cohort: m of n clients
    grads = vmap(grad(loss))(w, batches)      # deliver: the cohort at once
    grads = grads.to(grad_dtype)              # the wire
    grads = attack.apply(grads, m_mal, ctx)   # craft: first-rows overwrite
    grads, mask = inject_and_quarantine(...)  # only with cfg.faults
    agg   = defense(grads, m, m_mal[, mask])  # tier-1 aggregate
    state = momentum_update(state, agg)       # apply

on one device.  Under ``cfg.participation < 1`` the cohort is m =
round(p n) clients, m_mal = round(p f) of them malicious (rows [0,
m_mal)), drawn each round as the JAX package draws them
(core/population.py:legacy_cohort); at p = 1 it is every client, m = n.
With ``cfg.local_steps`` k > 1 each client takes k SGD steps at the faded
lr and reports the pseudo-gradient (core/client.py); under
``cfg.partition='femnist_style'`` each client sees its batch through its
own affine transform.  ``cfg.grad_dtype='bfloat16'`` puts the wire in
bf16 after deliver: the attack crafts on it, the distance kernels take it
as bf16 (their bf16 route) and the coordinate-wise kernels widen it to
f32, as in the JAX package's Pallas suite; the aggregate is widened to
f32 before the server step.

``ctx`` is the round's :class:`AttackContext`: the
weights broadcast this round, the faded learning rate (as an f32 device
scalar) and the round index; the server step itself stays on the
constant base learning rate.  Which implementation a defense runs
follows the device of the gradient matrix alone: on ``cuda`` Krum,
TrimmedMean, Bulyan and Median go through the hand-written CUDA kernels
(unmasked Krum through the fused distance -> score kernel under its
cancellation guard, the route the JAX engine takes with
``aggregation_impl='pallas'``), on ``cpu`` the same calls take the
kernels' plain PyTorch versions.  No
option selects the plain versions on the card.

With ``cfg.faults`` (core/faults.py) each round injects the scheduled
dropouts, stragglers and corruptions into the crafted matrix, quarantines
what the server can see, and hands the effective-cohort mask to the
defense.  The divergence watchdog checks the weights at every evaluation
round and rolls back to the state at the start of :meth:`run` instead of
aborting, at most ``max_rollbacks`` times (the JAX engine's span-boundary
check, core/engine.py:_diverged/_rollback, without auto-checkpoints).

With ``cfg.data_augment`` (by default on for CIFAR100 alone, the
reference's rule) the round's gathered batch is reflect-cropped and
flipped before deliver (data/augment.py), bit for bit the JAX package's
augmentation.  On the card every matmul and convolution runs in IEEE
fp32: resolving a CUDA device turns TF32 off for both.

Evaluation runs on the host's cadence, every ``test_step`` rounds and
after the last one (reference main.py:73-95), and prints the reference's
``Test set:`` lines; under a backdoor each is followed by the attack's
``##Test malicious net: [POST]`` line, and the run opens with the
``BEFORE:`` accuracy line instead of ``Starting Training...``.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch

from attacking_federate_learning_tpu_torch.attacks.base import (
    Attack, AttackContext, NoAttack
)
from attacking_federate_learning_tpu_torch.config import (
    CIFAR100, ExperimentConfig
)
from attacking_federate_learning_tpu_torch.core import faults as F
from attacking_federate_learning_tpu_torch.core.client import (
    make_client_update_fn
)
from attacking_federate_learning_tpu_torch.core.evaluate import make_eval_fn
from attacking_federate_learning_tpu_torch.core.server import (
    ServerState, init_server_state, momentum_update
)
from attacking_federate_learning_tpu_torch.data.augment import (
    reflect_crop_flip, round_augment_key
)
from attacking_federate_learning_tpu_torch.data.datasets import load_dataset
from attacking_federate_learning_tpu_torch.core.population import (
    legacy_cohort
)
from attacking_federate_learning_tpu_torch.data.partition import (
    client_style_params, make_shards, round_batch_indices
)
from attacking_federate_learning_tpu_torch.defenses import (
    DEFENSES, check_defense_args
)
from attacking_federate_learning_tpu_torch.models.base import get_model
from attacking_federate_learning_tpu_torch.utils import threefry
from attacking_federate_learning_tpu_torch.utils.flatten import FlatParams

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist.  There is
    no silent fallback to the CPU: the caller asks for it by name.

    On a CUDA device this also turns TF32 off for cuBLAS matmuls and
    cuDNN convolutions (cuDNN's default is on), process-wide: the port
    computes in IEEE fp32, whoever calls it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            f"pass device='cpu' to run the plain PyTorch versions on the "
            f"CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def faded_lr(cfg: ExperimentConfig, t: int) -> float:
    """The round-t faded lr as the JAX round computes it with a traced
    round index: the Python product ``base_lr * fading_rate`` divided in
    float32 by ``t + fading_rate`` (reference server.py:50-52); an f32
    value."""
    return float(np.float32(cfg.learning_rate * cfg.fading_rate)
                 / (np.float32(t) + np.float32(cfg.fading_rate)))


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
        self.n = cfg.users_count
        self.f = cfg.corrupted_count
        # The round cohort (cfg.participation): static sizes, round(p f)
        # malicious and the honest remainder, random identities a round.
        if cfg.participation < 1.0:
            self.m = max(1, int(round(cfg.participation * self.n)))
            self.m_mal = min(int(round(cfg.participation * self.f)), self.m)
            if self.f > 0 and self.m_mal == 0:
                raise ValueError(
                    f"participation={cfg.participation} rounds the "
                    f"malicious cohort to 0 while f={self.f} — the attack "
                    f"would silently never run (static cohorts); raise "
                    f"participation or set mal_prop=0 explicitly")
            if self.m - self.m_mal > self.n - self.f:
                raise ValueError(
                    f"cohort needs {self.m - self.m_mal} honest clients "
                    f"but only {self.n - self.f} exist "
                    f"(n={self.n}, f={self.f}, "
                    f"participation={cfg.participation})")
        else:
            self.m, self.m_mal = self.n, self.f
        # The defense sees the round cohort, not the population.
        check_defense_args(cfg.defense, self.m, self.m_mal)
        self._part_key = threefry.key(cfg.seed ^ 0x9A47)
        self.grad_dtype = _DTYPES[cfg.grad_dtype]
        # A FaultConfig with every rate 0 is the zero-fault round.
        self.faults = (cfg.faults if cfg.faults is not None
                       and cfg.faults.enabled else None)
        if self.faults is not None:
            F.check_fault_support(cfg, cfg.participation)
        self.dataset = dataset or load_dataset(
            cfg.dataset, cfg.data_dir, cfg.seed,
            synth_train=cfg.synth_train, synth_test=cfg.synth_test)
        # Reference parity: augmentation is part of the CIFAR100 train
        # pipeline only (reference data_sets.py:157-166); image-shaped
        # data required.
        self.augment = (cfg.data_augment if cfg.data_augment is not None
                        else cfg.dataset == CIFAR100)
        if self.augment and np.ndim(self.dataset.train_x) != 4:
            raise ValueError(
                f"data_augment needs (N, C, H, W) images, got "
                f"shape {np.shape(self.dataset.train_x)} for {cfg.dataset}")

        defense = DEFENSES[cfg.defense]
        # distance_dtype reaches the distance kernels of Krum and Bulyan
        # (None: as the JAX package leaves it unset at 'float32').
        dist_dtype = (None if cfg.distance_dtype == "float32"
                      else cfg.distance_dtype)
        if cfg.defense == "Krum":
            # The fused distance -> score kernel under the cancellation
            # guard, exact sort over the distance kernel when it fails.
            defense = functools.partial(
                defense, method="fused",
                paper_scoring=cfg.krum_paper_scoring,
                distance_dtype=dist_dtype)
        elif cfg.defense == "Bulyan":
            defense = functools.partial(
                defense, paper_scoring=cfg.krum_paper_scoring,
                distance_dtype=dist_dtype,
                batch_select=cfg.bulyan_batch_select)
        self.defense_fn = defense

        gen = torch.Generator().manual_seed(cfg.seed)
        self.model = get_model(cfg.model, gen).to(self.device)
        self.flat = FlatParams(self.model)
        self.state = init_server_state(self.flat.module_vector(self.model))
        self.fault_state = None
        # The latest round's fault counts ('quarantined' a device tensor).
        self.last_round_faults = None
        if self.faults is not None:
            self._fault_key = F.fault_key(cfg)
            self.fault_state = F.init_fault_state(self.faults, self.m,
                                                  self.flat.dim, self.device)

        shards = make_shards(cfg.partition, self.dataset.train_y, self.n,
                             cfg.seed, cfg.dirichlet_alpha)
        self.shards = torch.from_numpy(shards).to(self.device, torch.int64)
        self.train_x = torch.from_numpy(self.dataset.train_x).to(self.device)
        self.train_y = torch.from_numpy(self.dataset.train_y).to(
            self.device, torch.int64)
        # FEMNIST-style feature shift: client i sees a_i * x + b_i in its
        # training batches and its metadata samples; the test set and the
        # backdoor's shadow training read the raw data.
        self._style = None
        if cfg.partition == "femnist_style":
            self._style = tuple(
                torch.from_numpy(v).to(self.device)
                for v in client_style_params(self.n, cfg.style_strength,
                                             cfg.seed))
        self._client_update = make_client_update_fn(self.model, self.flat,
                                                    cfg.local_steps)
        self.metadata = (self.collect_metadata() if cfg.collect_metadata
                         else None)
        self.evaluate = make_eval_fn(self.model, self.flat,
                                     self.dataset.test_x,
                                     self.dataset.test_y, cfg.batch_size,
                                     self.device)

    def participants(self, t: int) -> Optional[np.ndarray]:
        """Round-t cohort ids, (m,) int32 on the host, or None under full
        participation: the first m_mal malicious ids (< f), then honest
        ones, the JAX package's draw (core/population.py)."""
        if self.cfg.participation >= 1.0:
            return None
        return legacy_cohort(self._part_key, t, self.n, self.f, self.m,
                             self.m_mal)

    def collect_metadata(self):
        """The metadata pool (reference C12, server.py:58-77): each
        client's stratified ~metadata_fraction sample of its first batch
        (reference user.py:63-66), concatenated, as host numpy (meta_x,
        meta_y) — the JAX package's pool byte for byte, styled rows
        included under 'femnist_style'."""
        cfg = self.cfg
        shards = self.shards.cpu().numpy()
        xs, ys = self.dataset.train_x, self.dataset.train_y
        rng = np.random.default_rng(cfg.seed + 42)
        meta_x, meta_y = [], []
        for i in range(self.n):
            batch = shards[i, : cfg.batch_size]
            labels = ys[batch]
            take = max(1, int(round(cfg.metadata_fraction * len(batch))))
            picked = []
            for c in np.unique(labels):
                pool = batch[labels == c]
                k = max(1, int(round(take * len(pool) / len(batch))))
                picked.extend(rng.choice(pool, size=min(k, len(pool)),
                                         replace=False).tolist())
            picked = np.asarray(picked[:take], np.int64)
            x_i = xs[picked]
            if self._style is not None:
                a, b = (float(v[i]) for v in self._style)
                x_i = np.float32(a) * x_i + np.float32(b)
            meta_x.append(x_i)
            meta_y.append(ys[picked])
        return np.concatenate(meta_x), np.concatenate(meta_y)

    def get_metadata(self):
        """Reference server.get_MetaData (server.py:58-59)."""
        return self.metadata

    def gather_batches(self, t: int, part=None):
        """Round-t minibatches of the cohort ``part`` (host ids or their
        int64 device copy; None: every client): one (m, k B) gather from
        the device-resident training set (k = local_steps)."""
        shards = self.shards
        if part is not None:
            shards = shards[torch.as_tensor(part, dtype=torch.int64,
                                            device=self.device)]
        idx = round_batch_indices(
            shards, t, self.cfg.batch_size * self.cfg.local_steps)
        return self.train_x[idx], self.train_y[idx]

    def apply_style(self, xs: torch.Tensor, part):
        """'femnist_style': row i of the cohort batch becomes a_i xs_i +
        b_i; any other partition leaves it as it is.  ``part`` as for
        :meth:`gather_batches`."""
        if self._style is None:
            return xs
        a, b = self._style
        if part is not None:
            idx = torch.as_tensor(part, dtype=torch.int64,
                                  device=self.device)
            a, b = a[idx], b[idx]
        shape = (xs.shape[0],) + (1,) * (xs.ndim - 1)
        return a.reshape(shape) * xs + b.reshape(shape)

    def compute_grads(self, t: int,
                      part: Optional[np.ndarray] = None) -> torch.Tensor:
        """deliver: the cohort's (m, d) updates at the server weights of
        round t on the wire (grad_dtype): gradients, or with local steps
        the pseudo-gradients, on the round-t styled and augmented batch.
        ``part`` is the round's cohort (:meth:`participants`), drawn here
        when it is not given."""
        cfg = self.cfg
        if part is None:
            part = self.participants(t)
        if part is not None:    # one host-to-device copy a round
            part = torch.from_numpy(part).to(self.device, torch.int64)
        xs, ys = self.gather_batches(t, part)
        xs = self.apply_style(xs, part)
        if self.augment:
            xs = reflect_crop_flip(xs, round_augment_key(cfg.seed, t))
        k, B = cfg.local_steps, cfg.batch_size
        xs = xs.reshape((self.m, k, B) + xs.shape[2:])
        ys = ys.reshape((self.m, k, B))
        # Clients train at the faded lr the server dispatches; the
        # pseudo-gradient divides by the lr the server multiplies back.
        lr_train = torch.full((), faded_lr(cfg, t), dtype=torch.float32,
                              device=self.device)
        lr_report = lr_train if cfg.server_uses_faded_lr else (
            cfg.learning_rate)
        grads = self._client_update(self.state.weights, xs, ys, lr_train,
                                    lr_report)
        return grads.to(self.grad_dtype).contiguous()

    def inject_and_quarantine(self, grads: torch.Tensor, t: int):
        """Fault seam: inject the round-t faults into the submitted
        matrix, then mask and zero what the server can detect.  Returns
        the aggregable matrix and the (n,) effective-cohort mask, and
        records the round's counts in ``last_round_faults``."""
        grads, dropped, self.fault_state, stats = F.apply_faults(
            grads, t, self._fault_key, self.fault_state, self.faults,
            self.m_mal)
        clean, mask, qstats = F.quarantine(grads, dropped)
        self.last_round_faults = {"round": t, **stats, **qstats}
        return clean, mask

    def attack_context(self, t: int) -> AttackContext:
        """The round-t attack context, with the faded lr (:func:`faded_lr`)
        as an f32 device scalar."""
        return AttackContext(
            original_params=self.state.weights,
            learning_rate=torch.full((), faded_lr(self.cfg, t),
                                     dtype=torch.float32,
                                     device=self.device),
            round=t)

    def run_round(self, t: int) -> ServerState:
        cfg = self.cfg
        grads = self.compute_grads(t, self.participants(t))
        grads = self.attacker.apply(grads, self.m_mal,
                                    self.attack_context(t))    # craft
        if self.faults is None:
            agg = self.defense_fn(grads, self.m, self.m_mal)   # aggregate
        else:
            grads, mask = self.inject_and_quarantine(grads, t)
            agg = self.defense_fn(grads, self.m, self.m_mal, mask=mask)
        # Reference parity: the constant base lr on the server
        # (server.py:89) unless server_uses_faded_lr.
        lr = (faded_lr(cfg, t) if cfg.server_uses_faded_lr
              else cfg.learning_rate)
        self.state = momentum_update(self.state, agg.float(), lr,
                                     cfg.momentum)             # apply
        return self.state

    def _snapshot(self):
        """A copy of the server state and the fault ring: the watchdog's
        rollback target."""
        st = self.state
        return (ServerState(st.weights.clone(), st.velocity.clone(),
                            st.round),
                {k: v.clone() for k, v in self.fault_state.items()})

    def _diverged(self) -> bool:
        """Divergence predicate (one device-to-host read): non-finite
        weights, or a weight norm beyond FaultConfig.watchdog_norm."""
        w = self.state.weights
        return not bool(torch.isfinite(w).all()) or float(
            torch.linalg.vector_norm(w)) > self.faults.watchdog_norm

    def _rollback(self, log, epoch: int) -> None:
        """Restore the last good snapshot; raise FloatingPointError once
        more than max_rollbacks were needed (the state restored first, so
        a caller that catches it holds a finite state)."""
        self._rollbacks += 1
        self.state, self.fault_state = self._last_good
        self._last_good = self._snapshot()    # the ring is updated in place
        restored = self.state.round
        log(f"!! server state diverged after round {epoch}; rolling "
            f"back to round {restored} "
            f"(rollback {self._rollbacks}/{self.faults.max_rollbacks})")
        if self._rollbacks > self.faults.max_rollbacks:
            raise FloatingPointError(
                f"server state diverged after round {epoch} and "
                f"exhausted {self.faults.max_rollbacks} rollbacks "
                f"(restored to round {restored})")

    def run(self, log: Callable[[str], None] = print) -> dict:
        """Full experiment loop (reference main.py:64-95): ``cfg.epochs``
        rounds, evaluated every ``test_step`` rounds and after the last,
        each evaluation reported as the reference's ``Test set:`` line
        through ``log``.

        With faults the result also holds ``faults``, one dict of counts
        per round run (a rolled-back round appears again when it is run
        again), read to the host at the evaluation rounds only; with the
        watchdog on, a diverged state at an evaluation round is rolled
        back before it is evaluated.

        Under a backdoor (``cfg.backdoor`` and an attacker with
        ``test_asr``) the result also holds ``asr``, the attack success
        rate of the server weights at each evaluation."""
        cfg = self.cfg
        test_size = len(self.dataset.test_y)
        accuracies, epochs, fault_rows, pending = [], [], [], []
        asr = []
        backdoor = bool(cfg.backdoor) and hasattr(self.attacker, "test_asr")
        watchdog = self.faults is not None and self.faults.watchdog
        self._rollbacks = 0
        if watchdog:
            self._last_good = self._snapshot()
        if cfg.backdoor:
            # Pre-training accuracy line (reference main.py:45-51).
            loss0, correct0 = self.evaluate(self.state.weights)
            log("\nBEFORE: Test set. Average loss: {:.4f}, Accuracy: {}/{} "
                "({:.2f}%)".format(float(loss0), int(correct0), test_size,
                                   100.0 * float(correct0) / test_size))
        else:
            log("\nStarting Training...")
        epoch = int(self.state.round)
        while epoch < cfg.epochs:
            self.run_round(epoch)
            if self.faults is not None:
                pending.append(self.last_round_faults)
            if epoch % cfg.test_step and epoch != cfg.epochs - 1:
                epoch += 1
                continue
            if pending:
                counts = torch.stack([r["quarantined"] for r in pending])
                fault_rows += [{**row, "quarantined": q}
                               for row, q in zip(pending, counts.tolist())]
                pending = []
            if watchdog and self._diverged():
                self._rollback(log, epoch)
                epoch = int(self.state.round)
                continue
            test_loss, correct = self.evaluate(self.state.weights)
            accuracy = 100.0 * float(correct) / test_size
            accuracies.append(accuracy)
            epochs.append(epoch)
            log("Test set: [{:3d}] Average loss: {:.4f}, "
                "Accuracy: {}/{} ({:.2f}%)".format(
                    epoch, float(test_loss), int(correct), test_size,
                    accuracy))
            if backdoor:
                # Post-aggregation backdoor check, printed after the
                # accuracy line as in the reference (main.py:91-95).
                asr.append(self.attacker.test_asr(self.state.weights, log,
                                                  tag="POST"))
            epoch += 1
        if accuracies:
            log("Max accuracy: {}".format(max(accuracies)))
        result = {"accuracies": accuracies, "epochs": epochs,
                  "final_weights": self.state.weights}
        if self.faults is not None:
            result["faults"] = fault_rows
        if backdoor:
            result["asr"] = asr
        return result
