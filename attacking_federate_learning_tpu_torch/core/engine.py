"""Experiment engine: the flat, synchronous FedSGD round, the
asynchronous buffered round and the hierarchical two-tier round.

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
defense.  The divergence watchdog checks the weights at every host
boundary (below) and rolls back to the last auto-checkpointed state, or
the state at the start of :meth:`run`, instead of aborting, at most
``max_rollbacks`` times (the JAX engine's core/engine.py:_diverged/
_rollback).

:meth:`run` runs one round at a time, and stops on the host at the
rounds where the JAX engine's default path ends a scanned span: every
``test_step``-th round, the last round, and every ``checkpoint_every``-th
round.  There it reads the fault and async counts, commits the rounds to
the journal, checks the watchdog, evaluates (eval rounds), writes the
auto-checkpoint (checkpoint rounds) and polls the shutdown request, so
``FL_PREEMPT_AT_ROUND=k`` stops both engines at the same round.  Events
are the JAX package's schema v14 (utils/metrics.py); the journal
(utils/lifecycle.py) makes them exactly-once across restarts.

Under ``cfg.aggregation='async'`` (core/async_rounds.py) a round is

    grads = vmap(grad(loss))(w, batches)           # every client, fresh
    dgrads, delivered, staleness = async_step(...) # ring -> pending -> k
    dgrads = attack.apply(dgrads, m_mal, ctx)      # craft at delivery
    w_s   = staleness_weights(staleness, delivered)
    agg   = defense(dgrads, m, m_mal, mask=delivered, weights=w_s)
    state = momentum_update(state, agg) if any(delivered) else state

the JAX engine's ``async_core``: the attack crafts from the delivered
malicious rows (``ctx.staleness``), the delivered rows are masked again
after it, and a round that delivers nothing leaves weights and velocity
as they were while the round counter advances (a select on the device,
no host read).  Faults compose inside ``async_step``; the straggler ring
of the flat round is never built.  The ring and the pending pool are the
engine's carry state (:meth:`carry_state_host`).

With ``cfg.traffic`` (core/population.py) a flat round's cohort comes
from the host-planned traffic schedule: m population clients gathered by
their shard archetype (data shard and style), the rows that did not
arrive zeroed and masked after the craft, the faults composed on that
mask, and the watchdog's ladder action: 'remask' runs the defense over
the arrived rows, 'fallback' ``traffic.fallback_defense``, 'hold' leaves
weights and velocity as they were (the round counter advances).  The v11
'traffic' events go out at the host boundaries.  In async rounds the
traffic latency profile replaces the uniform arrival draw.

Under ``cfg.aggregation='hierarchical'`` (ops/federated.py) the client
axis streams through S = n/m megabatches of ``cfg.megabatch`` clients,
placed by ``make_placement`` with the malicious ids first in each:

    for s in megabatches:                        # in megabatch order
        grads = vmap(grad(loss))(w, batches[s])  # deliver: (m, d)
        grads = attack.apply(grads, c_mal[s], ctx)  # craft from s's rows
        est[s] = defense(grads, m, f1[, mask])   # tier-1 estimate (d,)
    agg   = tier2(est, S, f2[, alive_counts])    # shard reduce over (S, d)
    state = momentum_update(state, agg)

Only one megabatch's (m, d) matrix is live at a time; the (S, d)
estimates go into a preallocated buffer, and the (n, d) matrix never
exists.  The engine adds no host synchronization inside the loop: an
attack that checks its crafted vector (the backdoor) leaves a flag per
megabatch on the device, read once a round before the state is
committed.  With faults each megabatch draws its own per-client faults
(keyed by its shard id) and hands its (m,) quarantine mask to the
tier-1 defense, the straggler ring has a shard axis, and dead shard
domains reach tier 2 with an alive count of 0; the host plans the tier-2
ladder (the configured tier-2 defense, the masked shard median, or hold)
from the surviving-shard count.  Under traffic every megabatch slot
re-draws its population archetype each round
(core/population.py:resample_slots).

The beyond-reference defenses (DnC, GeoMedian, CenteredClip, FLTrust,
NormBound) take their constants from the config; DnC gets the round
index (``needs_round``: fresh sketches a round) and FLTrust the server's
gradient over the metadata pool (``needs_server_grad``), as in the JAX
engine.

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

import contextlib
import functools
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from attacking_federate_learning_tpu_torch.attacks.base import (
    Attack, AttackContext, NoAttack
)
from attacking_federate_learning_tpu_torch.config import (
    CIFAR100, ExperimentConfig
)
from attacking_federate_learning_tpu_torch.core import async_rounds as A
from attacking_federate_learning_tpu_torch.core import faults as F
from attacking_federate_learning_tpu_torch.core import population as P
from attacking_federate_learning_tpu_torch.core.client import (
    make_client_update_fn, make_loss_fn
)
from attacking_federate_learning_tpu_torch.core.evaluate import make_eval_fn
from attacking_federate_learning_tpu_torch.core.server import (
    ServerState, init_server_state, momentum_update
)
from attacking_federate_learning_tpu_torch.data.augment import (
    reflect_crop_flip, round_augment_key
)
from attacking_federate_learning_tpu_torch.data.datasets import load_dataset
from attacking_federate_learning_tpu_torch.data.partition import (
    client_style_params, make_shards, round_batch_indices
)
from attacking_federate_learning_tpu_torch.defenses import (
    DEFENSES, check_defense_args
)
from attacking_federate_learning_tpu_torch.defenses.kernels import (
    TIER2_DEFENSES, check_tier2_args
)
from attacking_federate_learning_tpu_torch.models.base import get_model
from attacking_federate_learning_tpu_torch.ops import federated as FD
from attacking_federate_learning_tpu_torch.utils import threefry
from attacking_federate_learning_tpu_torch.utils.flatten import FlatParams
from attacking_federate_learning_tpu_torch.utils.metrics import RunLogger

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
    """The FedSGD experiment of ``cfg`` (a flat, async or hierarchical
    round, ``cfg.aggregation``) on ``device`` (default ``cuda``).
    ``dataset`` defaults to ``load_dataset`` of the config; ``attacker``
    defaults to no attack."""

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
        # The defense sees the round cohort, not the population, in async
        # rounds the delivered sub-cohort, in hierarchical rounds one
        # megabatch (tier 1) and the shard-estimate matrix (tier 2).
        self.async_spec = None
        self._placement = None
        if cfg.aggregation == "async":
            self._init_async()
        elif cfg.aggregation == "hierarchical":
            self._init_hierarchical()
        else:
            check_defense_args(cfg.defense, self.m, self.m_mal)
        if (getattr(self.attacker, "timed", False)
                and cfg.aggregation != "async"):
            raise ValueError(
                "a timed attack (attacks/backdoor.py "
                "TimedBackdoorAttack) games the async arrival schedule; "
                "it requires aggregation='async' — under synchronous "
                "topologies there is no arrival time to game")
        self._part_key = threefry.key(cfg.seed ^ 0x9A47)
        self.grad_dtype = _DTYPES[cfg.grad_dtype]
        # A FaultConfig with every rate 0 is the zero-fault round.
        self.faults = (cfg.faults if cfg.faults is not None
                       and cfg.faults.enabled else None)
        if self.faults is not None:
            F.check_fault_support(cfg, cfg.participation)
        # Population & traffic (core/population.py): a lazy registry of
        # scalars, so memory scales with the cohort m, not the population.
        self.traffic = self.registry = None
        self._traffic_latency = None
        if cfg.traffic is not None and cfg.traffic.enabled:
            P.check_traffic_support(cfg)
            if not getattr(self.attacker, "fusable", True):
                raise ValueError(
                    "the traffic engine requires a fusable attack (the "
                    "staged host-eager path has no arrival seam)")
            self.traffic = cfg.traffic
            self.registry = P.PopulationRegistry(cfg.traffic, self.n, self.f,
                                                 cfg.seed)
            self._traffic_events = {}
            # Hierarchical traffic is slot resampling only (its own key):
            # rounds stay full, no schedule, no ladder.
            self._traffic_key = P.traffic_key(cfg)
            if self.async_spec is not None:
                # Async traffic: the latency profile's heavy-tail delays
                # replace the uniform arrival draw in the ring.
                self._traffic_latency = P.async_latency_for_cfg(cfg, self.m)
            elif self._placement is None:
                # Ladder step 2: the bounds-valid fallback kernel.
                self._traffic_fallback_fn = DEFENSES[
                    cfg.traffic.fallback_defense]
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
        elif cfg.defense == "DnC":
            # The sketch keys flow from the experiment seed, so runs with
            # different seeds draw different coordinate subsets.
            defense = functools.partial(
                defense, n_iters=cfg.dnc_iters,
                sketch_dim=cfg.dnc_sketch_dim,
                filter_frac=cfg.dnc_filter_frac, seed=cfg.seed)
            defense.needs_round = True     # a partial drops attributes
        elif cfg.defense == "GeoMedian":
            defense = functools.partial(defense, iters=cfg.geomed_iters,
                                        eps=cfg.geomed_eps)
        elif cfg.defense == "CenteredClip":
            defense = functools.partial(defense, tau=cfg.cclip_tau,
                                        iters=cfg.cclip_iters)
        self.defense_fn = defense

        gen = torch.Generator().manual_seed(cfg.seed)
        self.model = get_model(cfg.model, gen).to(self.device)
        self.flat = FlatParams(self.model)
        self.state = init_server_state(self.flat.module_vector(self.model))
        self.fault_state = None
        # The latest round's fault counts ('quarantined' a device tensor)
        # and, in async rounds, its async stats (device tensors).
        self.last_round_faults = None
        self.last_round_async = None
        if self.faults is not None:
            self._fault_key = F.fault_key(cfg)
            if self._placement is not None:
                # One (m, d) slab per shard per delay slot; the ladder's
                # fallback is the masked shard median.
                self.fault_state = F.init_hier_fault_state(
                    self.faults, self._placement.num_shards,
                    self._placement.megabatch, self.flat.dim, self.device)
                self._tier2_fallback_fn = TIER2_DEFENSES[F.TIER2_FALLBACK]
            elif self.async_spec is None:
                # Async rounds model stragglers as extra arrival delay in
                # their own buffers: the straggler ring never exists.
                self.fault_state = F.init_fault_state(
                    self.faults, self.m, self.flat.dim, self.device)
        self.async_state = None
        if self.async_spec is not None:
            self.async_state = A.init_async_state(
                self.async_spec, self.m, self.flat.dim, self.device)
        if self._placement is not None:
            # The (S, d) tier-1 estimates, written in place a round, and
            # the placement's id grid on the device.
            self._estimates = torch.empty(
                (self._placement.num_shards, self.flat.dim),
                dtype=torch.float32, device=self.device)
            self._grid = torch.from_numpy(self._placement.grid).to(
                self.device, torch.int64)
            self.last_round_slots = None

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
        # Validation-data defense (FLTrust): the server's own gradient on
        # the trusted metadata pool is the trust anchor; the pool is made
        # whenever the defense needs it, and lives on the device.
        self._needs_round = getattr(self.defense_fn, "needs_round", False)
        self._needs_server_grad = getattr(self.defense_fn,
                                          "needs_server_grad", False)
        self.metadata = (self.collect_metadata()
                         if cfg.collect_metadata or self._needs_server_grad
                         else None)
        if self._needs_server_grad:
            self._meta_x = torch.from_numpy(self.metadata[0]).to(self.device)
            self._meta_y = torch.from_numpy(self.metadata[1]).to(
                self.device, torch.int64)
            self._server_grad_fn = torch.func.grad(
                make_loss_fn(self.model, self.flat))
        self.evaluate = make_eval_fn(self.model, self.flat,
                                     self.dataset.test_x,
                                     self.dataset.test_y, cfg.batch_size,
                                     self.device)

    def _init_async(self):
        """Check and plan the buffered round, with the JAX engine's checks
        and messages (its core/engine.py:_init_async): the async config
        checks, a fusable attack, k <= m, the defense's bound at n = k
        (a delivered round aggregates exactly k rows, the full f
        colluders assumed delivered), and TrimmedMean's k - f - 1 >= 1."""
        cfg = self.cfg
        A.check_async_support(cfg)
        if not getattr(self.attacker, "fusable", True):
            raise ValueError(
                "--aggregation async needs a fusable attack: delivery, "
                "staleness weighting and the attack seam live inside "
                "the fused round program")
        if cfg.async_buffer > self.m:
            raise ValueError(
                f"--async-buffer {cfg.async_buffer} exceeds the cohort "
                f"(m={self.m}): the FedBuff trigger would never fire — "
                f"the pending pool holds at most one update per client")
        try:
            check_defense_args(cfg.defense, cfg.async_buffer, self.m_mal)
        except ValueError as e:
            raise ValueError(
                f"--aggregation async aggregates exactly "
                f"k=--async-buffer rows per applied round, so the "
                f"defense bound applies at n=k: {e}") from e
        if (cfg.defense == "TrimmedMean"
                and cfg.async_buffer - self.m_mal - 1 < 1):
            raise ValueError(
                f"--aggregation async TrimmedMean keeps "
                f"k - f - 1 rows per applied round; got "
                f"k={cfg.async_buffer}, f={self.m_mal} — raise "
                f"--async-buffer")
        self.async_spec = A.AsyncSpec(
            buffer=cfg.async_buffer, max_staleness=cfg.async_max_staleness,
            weighting=cfg.staleness_weight,
            timed=bool(getattr(self.attacker, "timed", False)))
        self._async_key = A.async_key(cfg)

    def _init_hierarchical(self):
        """Check and plan the two-tier round, with the JAX engine's checks
        and messages (its core/engine.py:_init_hierarchical): full
        participation, the fused backdoor, a tier-1 defense of the
        mask-aware set, a fusable attack; the placement, the assumed
        corrupted bounds per tier (ceil(f/S) and ceil(f/m) unless the
        config sets them) and each tier's validity bound.  The device
        mesh and secure aggregation are refused: they are later slices
        of the port."""
        cfg = self.cfg
        if getattr(cfg, "mesh_shape", None) is not None:
            raise ValueError(
                "--mesh-shape is not ported yet: the SPMD client_map over "
                "a device mesh is the multi-GPU slice of the port; the "
                "port runs the hierarchical round's megabatches in order "
                "on one device (drop --mesh-shape)")
        if getattr(cfg, "secagg", "off") != "off":
            raise ValueError(
                "--secagg is not ported yet: group-wise secure "
                "aggregation over the hierarchical round's megabatch "
                "sums is a later slice of the port (drop --secagg)")
        if cfg.participation < 1.0:
            raise ValueError(
                "hierarchical aggregation requires full participation "
                "(placement assigns every client to a megabatch)")
        if cfg.backdoor and not cfg.backdoor_fused:
            raise ValueError(
                "hierarchical aggregation needs the fused backdoor "
                "path (drop --backdoor-staged)")
        if cfg.defense not in TIER2_DEFENSES:
            raise ValueError(
                f"hierarchical tier-1 defense must be one of "
                f"{sorted(TIER2_DEFENSES)} (the mask-aware kernel "
                f"set), got {cfg.defense!r}")
        if not getattr(self.attacker, "fusable", True):
            raise ValueError(
                "hierarchical aggregation needs a fusable attack: the "
                "client axis lives inside a scanned device program")
        place = FD.make_placement(self.n, self.f, cfg.megabatch,
                                  cfg.mal_placement)
        S = place.num_shards
        self._placement = place
        self._tier1_f = (cfg.tier1_corrupted
                         if cfg.tier1_corrupted is not None
                         else FD.tier1_assumed(self.f, S))
        self._tier2_f = (cfg.tier2_corrupted
                         if cfg.tier2_corrupted is not None
                         else FD.tier2_assumed(self.f, cfg.megabatch))
        self._tier2_name = cfg.tier2_defense or cfg.defense
        check_tier2_args(cfg.defense, cfg.megabatch, self._tier1_f)
        check_tier2_args(self._tier2_name, S, self._tier2_f)
        self._tier2_fn = TIER2_DEFENSES[self._tier2_name]
        # The crafted-rows NaN guard (the backdoor's), one flag a
        # megabatch on the device.
        self._check_attack_nan = (
            getattr(self.attacker, "checks_finite", False)
            and self.m_mal > 0
            and getattr(self.attacker, "num_std", 1) != 0)

    def participants(self, t: int) -> Optional[np.ndarray]:
        """Round-t cohort ids, (m,) int32 on the host, or None under full
        participation: the first m_mal malicious ids (< f), then honest
        ones, the JAX package's draw (core/population.py)."""
        if self.cfg.participation >= 1.0:
            return None
        return P.legacy_cohort(self._part_key, t, self.n, self.f, self.m,
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

    def compute_grads(self, t: int, part=None) -> torch.Tensor:
        """deliver: the cohort's (m, d) updates at the server weights of
        round t on the wire (grad_dtype): gradients, or with local steps
        the pseudo-gradients, on the round-t styled and augmented batch.
        ``part`` is the round's cohort (:meth:`participants`), drawn here
        when it is not given, or a megabatch's ids (an int64 device
        tensor, hierarchical rounds)."""
        cfg = self.cfg
        if part is None:
            part = self.participants(t)
        if isinstance(part, np.ndarray):    # one host-to-device copy
            part = torch.from_numpy(part).to(self.device, torch.int64)
        rows = self.m if part is None else part.shape[0]
        xs, ys = self.gather_batches(t, part)
        xs = self.apply_style(xs, part)
        if self.augment:
            xs = reflect_crop_flip(xs, round_augment_key(cfg.seed, t))
        k, B = cfg.local_steps, cfg.batch_size
        xs = xs.reshape((rows, k, B) + xs.shape[2:])
        ys = ys.reshape((rows, k, B))
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

    def attack_context(self, t: int, staleness=None,
                       check_finite: bool = True) -> AttackContext:
        """The round-t attack context, with the faded lr (:func:`faded_lr`)
        as an f32 device scalar and, in async rounds, the delivered rows'
        staleness."""
        return AttackContext(
            original_params=self.state.weights,
            learning_rate=torch.full((), faded_lr(self.cfg, t),
                                     dtype=torch.float32,
                                     device=self.device),
            round=t, staleness=staleness, check_finite=check_finite)

    def server_grad(self) -> torch.Tensor:
        """(d,) f32: the server's gradient of the mean loss over the whole
        metadata pool at the current weights (FLTrust's trust anchor;
        BatchNorm models normalize with the pool's batch statistics)."""
        return self._server_grad_fn(self.state.weights, self._meta_x,
                                    self._meta_y)

    def aggregate(self, grads: torch.Tensor, t: int, **kw) -> torch.Tensor:
        """tier1_aggregate: the configured defense over the round's
        matrix, with the seams it asks for: the round index
        (``needs_round``, DnC's fresh sketches) and the server gradient
        (``needs_server_grad``, FLTrust); ``kw`` carries ``mask`` and
        ``weights``."""
        if self._needs_round:
            kw["round"] = t
        if self._needs_server_grad:
            kw["server_grad"] = self.server_grad()
        return self.defense_fn(grads, self.m, self.m_mal, **kw)

    def _apply(self, agg: torch.Tensor, t: int) -> ServerState:
        """apply: the momentum step on the aggregate, at the constant base
        lr on the server (reference server.py:89) unless
        server_uses_faded_lr."""
        cfg = self.cfg
        lr = (faded_lr(cfg, t) if cfg.server_uses_faded_lr
              else cfg.learning_rate)
        return momentum_update(self.state, agg.float(), lr, cfg.momentum)

    def _hold(self) -> ServerState:
        """A no-op round: weights and velocity stay bit for bit, the round
        counter advances."""
        st = self.state
        self.state = ServerState(st.weights, st.velocity, st.round + 1)
        return self.state

    def run_round(self, t: int) -> ServerState:
        if self.async_spec is not None:
            return self.run_async_round(t)
        if self._placement is not None:
            return self.run_hier_round(t)
        if self.traffic is not None:
            return self.run_traffic_round(t)
        grads = self.compute_grads(t, self.participants(t))
        grads = self.attacker.apply(grads, self.m_mal,
                                    self.attack_context(t))    # craft
        if self.faults is None:
            agg = self.aggregate(grads, t)                     # aggregate
        else:
            grads, mask = self.inject_and_quarantine(grads, t)
            agg = self.aggregate(grads, t, mask=mask)
        self.state = self._apply(agg, t)                       # apply
        return self.state

    def traffic_plan(self, t0: int, count: int) -> P.TrafficSchedule:
        """The host-sampled traffic schedule of rounds [t0, t0 + count):
        cohort shard ids, arrival masks and ladder actions, and the v11
        'traffic' events.  Pure in the traffic seed and the round index,
        so a resumed run regenerates it (no carry state)."""
        return P.traffic_schedule(
            self.registry, t0, count, self.m, self.m_mal, self.cfg.defense,
            self.traffic.fallback_defense, self.traffic.min_cohort)

    def run_traffic_round(self, t: int) -> ServerState:
        """One flat traffic round (the JAX engine's traffic branch of
        ``fused_core``): the round's schedule row from the host; deliver
        and craft over all m cohort rows, gathered by shard id (a
        population client is its archetype's data shard and style); then
        the rows that did not arrive are zeroed and masked; then the
        faults, masked with ``arrived & fmask``; then the ladder's action.
        'remask' runs the configured defense with the mask, 'fallback'
        the fallback defense with it, 'hold' no defense: weights and
        velocity stay bit for bit, the round counter advances.  The JAX
        engine computes both defenses and selects; the unselected one
        never reaches the state, so running the named one alone gives
        the same state."""
        sched = self.traffic_plan(t, 1)
        self._traffic_events[t] = sched.events[0]
        action = int(sched.action[0])
        grads = self.compute_grads(t, sched.shard_ids[0])      # deliver
        grads = self.attacker.apply(grads, self.m_mal,
                                    self.attack_context(t))    # craft
        mask = F.to_device(sched.arrived[0], self.device)
        grads = torch.where(mask[:, None], grads, torch.zeros_like(grads))
        if self.faults is not None:
            grads, fmask = self.inject_and_quarantine(grads, t)
            mask = mask & fmask
        if action == P.TRAFFIC_HOLD:
            return self._hold()
        if action == P.TRAFFIC_REMASK:
            agg = self.aggregate(grads, t, mask=mask)
        else:
            agg = self._traffic_fallback_fn(grads, self.m, self.m_mal,
                                            mask=mask)
        self.state = self._apply(agg, t)
        return self.state

    def slot_ids(self, t: int) -> np.ndarray:
        """Round t's (S, m) megabatch slots under traffic: every
        placement row resampled (core/population.py:resample_slots)."""
        place = self._placement
        return np.stack([
            P.resample_slots(self._traffic_key, t,
                             place.grid[s].astype(np.int64),
                             place.mal_counts[s], self.f, self.n)
            for s in range(place.num_shards)])

    def run_hier_round(self, t: int) -> ServerState:
        """One hierarchical round (the JAX engine's ``hier_core``, and
        ``fault_hier_core`` under faults): for each megabatch in order,
        deliver its (m, d) gradients, craft from its malicious rows, and
        write its tier-1 estimate into the (S, d) buffer; then the tier-2
        reduction and the momentum step.

        With faults, the round's draws are made on the host at once (the
        per-shard masks, the domain row, the ladder's action) and cross
        to the device in one copy; each megabatch injects its faults
        (its straggler slab updated in place), quarantines, and runs the
        masked tier-1 defense; its alive count is its quarantine
        survivors times its domain's liveness.  A shard with no alive row
        has its estimate zeroed.  The host-planned action runs the
        configured tier-2 defense over the alive shards ('remask'), the
        masked shard median ('fallback'), or holds.  Records the counts
        in ``last_round_faults``."""
        place, fc = self._placement, self.faults
        S, m, f1 = place.num_shards, place.megabatch, self._tier1_f
        grid = self._grid
        if self.traffic is not None:
            self.last_round_slots = self.slot_ids(t)
            grid = F.to_device(self.last_round_slots, self.device)
        action = P.TRAFFIC_REMASK
        if fc is not None:
            masks, dom, row = F.hier_round_faults(self._fault_key, t, place,
                                                  fc)
            action = int(F.plan_tier2_actions(
                [row["shards_alive"]], self._tier2_name, self._tier2_f)[0])
            masks = F.to_device(masks, self.device)          # (S, 3, m)
            dom = F.to_device(dom, self.device)
            alive = torch.empty(S, dtype=torch.int64, device=self.device)
            quar = torch.empty(S, dtype=torch.int64, device=self.device)
        bad = (torch.zeros(S, dtype=torch.bool, device=self.device)
               if self._check_attack_nan else None)
        ctx = self.attack_context(t, check_finite=bad is None)

        def shard_fn(sid, _ids, c):
            # The megabatch's ids on the device: the placement's, or the
            # round's resampled slots.  Its matrix is freed on return,
            # before the next megabatch's deliver.
            grads = self.compute_grads(t, grid[sid])             # deliver
            grads = self.attacker.apply(grads, c, ctx)           # craft
            if bad is not None and c > 0:
                bad[sid] = ~torch.isfinite(grads[:c]).all()
            if fc is None:
                return self.defense_fn(grads, m, f1)             # tier 1
            slab = (self.fault_state["stale"][t % fc.straggler_delay, sid]
                    if fc.straggler > 0 else None)
            grads, drop = F.apply_shard_faults(grads, masks[sid], slab, fc)
            grads, qmask, q = F.quarantine(grads, drop)
            quar[sid] = q["quarantined"]
            alive[sid] = qmask.sum() * dom[sid]
            return self.defense_fn(grads, m, f1, mask=qmask)

        est = FD.client_map(shard_fn, place, with_sid=True,
                            out=self._estimates)
        f2 = self._tier2_f
        if fc is None:
            agg = FD.shard_reduce(self._tier2_fn, est, S, f2)    # tier 2
        else:
            # A shard with no aggregable row has an undefined estimate;
            # tier 2's mask excludes it, and it is zeroed so nothing
            # non-finite can leak.
            est.masked_fill_((alive == 0)[:, None], 0.0)
            self.last_round_faults = {
                **{k: row[k] for k in ("round", "injected_dropout",
                                       "injected_straggler",
                                       "injected_corrupt")},
                "quarantined": quar.sum(),
                "shards_dead": row["shards_dead"],
                "shard_alive": alive,
                "shards_alive": (alive > 0).sum(),
                "tier2_action": action}
            agg = None
            if action != P.TRAFFIC_HOLD:
                fn = (self._tier2_fn if action == P.TRAFFIC_REMASK
                      else self._tier2_fallback_fn)
                agg = FD.shard_reduce(fn, est, S, f2, alive_counts=alive)
        if bad is not None and bool(bad.any()):
            # The state stays at the last finished round.
            raise FloatingPointError("Got nan in backdoor shadow training")
        if agg is None:
            return self._hold()
        self.state = self._apply(agg, t)                         # apply
        return self.state

    def run_async_round(self, t: int) -> ServerState:
        """One buffered round (the JAX engine's ``async_core``): fresh
        updates into the ring, delivery, the attack on the delivered
        matrix, the staleness-weighted masked defense, and the momentum
        step only if a row was delivered.  Records the round's stats in
        ``last_round_async`` (and the injected fault counts in
        ``last_round_faults``)."""
        spec = self.async_spec
        grads = self.compute_grads(t)                           # deliver
        dgrads, delivered, staleness, stats = A.async_step(
            grads, t, self._async_key, spec, self.async_state, self.m_mal,
            faults=self.faults,
            fkey=self._fault_key if self.faults is not None else None,
            latency=self._traffic_latency)
        if self.faults is not None:
            self.last_round_faults = {
                "round": t, **{k[len("fault_"):]: v for k, v in
                               stats.items() if k.startswith("fault_")}}
        # Craft at delivery; undelivered rows [0, f) get overwritten too,
        # so the matrix is masked again before the defense.
        crafted = self.attacker.apply(dgrads, self.m_mal,
                                      self.attack_context(t, staleness))
        agg_grads = torch.where(delivered[:, None], crafted, 0.0)
        weights = A.staleness_weights(staleness, delivered, spec.weighting)
        self.last_round_async = {
            "round": t, "counts": stats["counts"],
            "staleness_hist": stats["staleness_hist"],
            "weight_mass": A.weight_mass(staleness, delivered, weights,
                                         spec.depth),
            "delivered_mask": delivered, "staleness": staleness}
        kw = {} if weights is None else {"weights": weights}
        agg = self.aggregate(agg_grads, t, mask=delivered, **kw)
        upd = self._apply(agg, t)
        # An empty delivery is a server no-op: weights and velocity hold,
        # the round counter advances.
        any_del = delivered.any()
        self.state = ServerState(
            torch.where(any_del, upd.weights, self.state.weights),
            torch.where(any_del, upd.velocity, self.state.velocity),
            upd.round)
        return self.state

    # --- carry state and rollback ---------------------------------------
    def _host_state(self) -> ServerState:
        """Owned host copies of the server state."""
        st = self.state
        return ServerState(st.weights.to("cpu", copy=True).numpy(),
                           st.velocity.to("cpu", copy=True).numpy(),
                           int(st.round))

    def _place_state(self, st: ServerState) -> ServerState:
        """A host (or any-device) server state as fresh f32 tensors on the
        engine's device."""
        def place(a):
            return torch.as_tensor(a).to(self.device, torch.float32,
                                         copy=True)
        return ServerState(place(st.weights), place(st.velocity),
                           int(st.round))

    def carry_state_host(self):
        """Host copy of the cross-round carry state for the Checkpointer's
        ``extra=`` seam, the JAX engine's layout: in async rounds the ring
        and the pending pool, six arrays keyed ``async_buf``,
        ``async_occ``, ``async_birth``, ``async_pbuf``, ``async_pocc``,
        ``async_pbirth`` (f32, bool, int32); else the straggler ring
        ``{'stale': (delay, m, d) f32}`` under fault injection with
        stragglers, ``(delay, S, m, d)`` in hierarchical rounds; None
        when the engine carries nothing beyond the ServerState."""
        if self.async_state is not None:
            return {"async_" + k: v.to("cpu", copy=True).numpy()
                    for k, v in self.async_state.items()}
        if self.faults is None or not self.fault_state:
            return None
        return {k: v.to("cpu", copy=True).numpy()
                for k, v in self.fault_state.items()}

    def restore_carry_state(self, extra):
        """Put checkpointed carry state (the async buffers, or the
        straggler ring) back on the device after a resume, so a resumed
        run continues bit for bit.  Each array takes this engine's dtype;
        one of another shape than this engine's is refused."""
        if not extra:
            return
        if self.async_state is not None:
            if any(k.startswith("async_") for k in extra):
                restored = {}
                for k, ref in self.async_state.items():
                    arr = torch.as_tensor(extra["async_" + k]).to(
                        self.device, ref.dtype, copy=True)
                    if arr.shape != ref.shape:
                        raise ValueError(
                            f"checkpointed async_{k} has shape "
                            f"{tuple(arr.shape)}, this engine's is "
                            f"{tuple(ref.shape)} (async_max_staleness + "
                            f"1, cohort rows, d)")
                    restored[k] = arr
                self.async_state = restored
            return
        if self.faults is None or "stale" not in extra:
            return
        want = tuple(self.fault_state["stale"].shape)
        ring = torch.as_tensor(extra["stale"]).to(self.device,
                                                  torch.float32, copy=True)
        if tuple(ring.shape) != want:
            axes = ("straggler_delay, S, m, d" if self._placement is not None
                    else "straggler_delay, cohort rows, d")
            raise ValueError(
                f"checkpointed straggler ring has shape "
                f"{tuple(ring.shape)}, this engine's is {want} ({axes})")
        self.fault_state = {"stale": ring}

    def restore_fault_state(self, extra):
        """Alias of :meth:`restore_carry_state` (the JAX engine's older
        name)."""
        self.restore_carry_state(extra)

    def fault_state_host(self):
        """Alias of :meth:`carry_state_host` (the JAX engine's older
        name)."""
        return self.carry_state_host()

    def _diverged(self) -> bool:
        """Divergence predicate (one device-to-host read): non-finite
        weights, or a weight norm beyond FaultConfig.watchdog_norm."""
        w = self.state.weights
        return not bool(torch.isfinite(w).all()) or float(
            torch.linalg.vector_norm(w)) > self.faults.watchdog_norm

    def _rollback(self, logger, epoch: int, checkpointer) -> None:
        """Restore the last good state (the latest auto-checkpoint
        boundary's, else the start of :meth:`run`'s), emit a 'fault'
        rolled_back event, persist the restored state as an on-failure
        auto-checkpoint, and raise FloatingPointError once more than
        max_rollbacks were needed (the state restored first, so a caller
        that catches it holds a finite state)."""
        self._rollbacks += 1
        st, carry = self._last_good
        restored = int(st.round)
        logger.record(kind="fault", round=int(epoch), rolled_back=1,
                      restored_round=restored,
                      rollbacks_total=self._rollbacks)
        logger.print(
            f"!! server state diverged after round {epoch}; rolling "
            f"back to round {restored} "
            f"(rollback {self._rollbacks}/{self.faults.max_rollbacks})")
        self.state = self._place_state(st)
        if carry is not None:
            self.restore_carry_state(carry)
        if checkpointer is not None:
            # On-failure checkpoint: an external --resume lands on the
            # round rolled back to.
            checkpointer.save_auto(self.state, extra=carry)
        if self._rollbacks > self.faults.max_rollbacks:
            raise FloatingPointError(
                f"server state diverged after round {epoch} and "
                f"exhausted {self.faults.max_rollbacks} rollbacks "
                f"(restored to round {restored})")

    def _preempt(self, logger, checkpointer, epoch, journal, shutdown):
        """Honor a shutdown request at a host boundary: write an
        auto-checkpoint (with a Checkpointer of its own when the caller
        runs without one: a preempt must not lose the run), record a
        'lifecycle' preempt event, mark the journal and raise Preempted
        (utils/lifecycle.py)."""
        from attacking_federate_learning_tpu_torch.utils.checkpoint import (
            Checkpointer
        )
        from attacking_federate_learning_tpu_torch.utils.lifecycle import (
            EXIT_PREEMPTED, Preempted
        )

        ck = checkpointer or Checkpointer(
            self.cfg, auto_dir=journal.dir if journal is not None else None)
        path = ck.save_auto(self.state, extra=self.carry_state_host())
        source = shutdown.source or "signal"
        logger.record(kind="lifecycle", phase="preempt", round=int(epoch),
                      source=source, checkpoint=path,
                      attempt=journal.attempt if journal is not None else 1)
        logger.print(f"!! preempted ({source}) after round {epoch}; "
                     f"state checkpointed to {path}; "
                     f"exiting {EXIT_PREEMPTED} (resumable)")
        if journal is not None:
            journal.finish("preempted", EXIT_PREEMPTED, checkpoint=path)
            journal.close()
        raise Preempted(epoch, source)

    # --- the experiment loop -----------------------------------------------
    def run(self, logger: Optional[RunLogger] = None, checkpointer=None,
            journal=None, shutdown=None,
            log: Optional[Callable[[str], None]] = None) -> dict:
        """Full experiment loop (reference main.py:64-95): ``cfg.epochs``
        rounds, evaluated every ``test_step`` rounds and after the last,
        with the JAX engine's ``run`` semantics (its core/engine.py).

        ``logger``: a utils.metrics.RunLogger (the reference's lines, the
        accuracy CSV and the event log).  With ``log`` instead, the lines
        go to that callable and the events stay in memory (a RunLogger
        with ``log_dir=None``); with neither, the engine makes a
        RunLogger of ``cfg.output`` / ``cfg.log_dir`` and closes it.

        ``checkpointer``: a utils.checkpoint.Checkpointer.  The state is
        saved above ``checkpoint_acc_threshold`` accuracy (keep-best) and,
        with ``cfg.checkpoint_every``, as an auto-checkpoint at every
        such boundary, the carry state (the async buffers or the
        straggler ring) in ``extra=``.  A checkpoint boundary's state is
        also the watchdog's new rollback target.

        ``journal``: a utils.lifecycle.RunJournal.  Rounds and evals are
        committed at the host boundaries exactly once across restarts;
        'fault' events of rounds at or below its high-water mark and
        committed evals are not emitted again.  It gets the 'lifecycle'
        start/resume/complete events, the 'registry' stamp, the
        manifest's summary and the run's index entry.

        ``shutdown``: a utils.lifecycle.GracefulShutdown, polled at each
        host boundary; a request checkpoints and raises Preempted.

        Returns ``accuracies`` and ``epochs`` (this attempt's
        evaluations), ``final_weights``, and with faults ``faults`` (one
        dict of counts per round run in this attempt, a rolled-back
        round again when it is run again), in async rounds ``async`` (the
        'async' event of each round run in this attempt), in flat traffic
        rounds ``traffic`` (the 'traffic' event of each round run in this
        attempt), under a backdoor ``asr`` (the attack success rate at
        each evaluation)."""
        own = logger is None and log is None
        if logger is None:
            logger = (RunLogger(self.cfg, self.cfg.output, self.cfg.log_dir)
                      if own else RunLogger(self.cfg, log_dir=None, log=log))
        with contextlib.ExitStack() as stack:
            if own:
                stack.enter_context(logger)
            return self._run_body(logger, checkpointer, journal, shutdown)

    def _run_body(self, logger, checkpointer, journal, shutdown) -> dict:
        cfg = self.cfg
        test_size = len(self.dataset.test_y)
        backdoor = bool(cfg.backdoor) and hasattr(self.attacker, "test_asr")
        if cfg.backdoor:
            # Pre-training accuracy line (reference main.py:45-51).
            loss0, correct0 = self.evaluate(self.state.weights)
            logger.print(
                "\nBEFORE: Test set. Average loss: {:.4f}, Accuracy: {}/{} "
                "({:.2f}%)".format(float(loss0), int(correct0), test_size,
                                   100.0 * float(correct0) / test_size))
        else:
            logger.print("\nStarting Training...")

        ckpt_every = cfg.checkpoint_every
        watchdog = self.faults is not None and self.faults.watchdog
        self._rollbacks = 0
        if watchdog:
            # The rollback target until the first checkpoint boundary.
            self._last_good = (self._host_state(), self.carry_state_host())
        # A resumed ServerState carries its round counter.
        epoch = start_epoch = span_start = int(self.state.round)
        fault_rows, async_rows, traffic_rows, pending, asr = (
            [], [], [], [], [])
        last_asr = None
        if journal is not None:
            attempt = journal.start_attempt(epoch)
            phase = "start" if attempt == 1 and epoch == 0 else "resume"
            logger.record(kind="lifecycle", phase=phase, round=epoch,
                          attempt=attempt, replay_high=journal.high)
            if phase == "resume":
                logger.print(
                    f"[lifecycle] attempt {attempt} resumes at round "
                    f"{epoch} (journal high-water {journal.high}: "
                    f"replayed rounds/evals are not re-recorded)")

        def fresh(t):
            # Exactly-once events: a round at or below the journal's
            # high-water mark was recorded by the attempt that ran it.
            return journal is None or journal.fresh_round(t)

        loop_t0 = time.perf_counter()
        while epoch < cfg.epochs:
            self.run_round(epoch)
            if self.faults is not None or self.async_spec is not None:
                pending.append((self.last_round_faults,
                                self.last_round_async))
            is_eval = epoch % cfg.test_step == 0 or epoch == cfg.epochs - 1
            if not (is_eval or (ckpt_every and epoch % ckpt_every == 0)):
                epoch += 1
                continue
            # A host boundary: where the JAX engine's span ends.
            if pending:
                for frow, arow in self._host_records(pending):
                    if frow is not None:
                        fault_rows.append(frow)
                    if arow is not None:
                        async_rows.append(arow)
                    t_rec = (frow or arow)["round"]
                    if fresh(t_rec):
                        if frow is not None:
                            logger.record(kind="fault", **frow)
                        if arow is not None:
                            logger.record(kind="async", **arow)
                pending = []
            if self.traffic is not None:
                # Traffic events are host-born (the schedule knows the
                # arrivals and actions before the device runs), emitted at
                # the same exactly-once boundary, after the span's others.
                for tt in range(span_start, epoch + 1):
                    ev = self._traffic_events.pop(tt, None)
                    if ev is not None:
                        traffic_rows.append(ev)
                        if fresh(tt):
                            logger.record(kind="traffic", **ev)
            if journal is not None:
                journal.commit_rounds(span_start, epoch)
            if watchdog and self._diverged():
                # Restore the last good state and run again from there;
                # the eval below never sees the diverged weights.
                self._rollback(logger, epoch, checkpointer)
                epoch = span_start = int(self.state.round)
                continue
            if is_eval and (journal is None or journal.fresh_eval(epoch)):
                test_loss, correct = self.evaluate(self.state.weights)
                accuracy = logger.record_eval(epoch, test_loss, correct,
                                              test_size)
                if (accuracy > cfg.checkpoint_acc_threshold
                        and checkpointer is not None):
                    # The carry state rides every checkpoint: --resume
                    # takes the newest by round, best saves included.
                    checkpointer.save(self.state, accuracy,
                                      extra=self.carry_state_host())
                if backdoor:
                    # Post-aggregation backdoor check, printed after the
                    # accuracy line as in the reference (main.py:91-95).
                    last_asr = float(self.attacker.test_asr(
                        self.state.weights, logger.print, tag="POST"))
                    asr.append(last_asr)
                    logger.record(kind="asr", round=epoch,
                                  attack_success_rate=last_asr)
                if journal is not None:
                    journal.commit_eval(epoch)
            if ckpt_every and epoch % ckpt_every == 0 and (
                    watchdog or checkpointer is not None):
                # Periodic auto-checkpoint; the watchdog above has
                # certified this state, so it is the new rollback target.
                carry = self.carry_state_host()
                if watchdog:
                    self._last_good = (self._host_state(), carry)
                if checkpointer is not None:
                    checkpointer.save_auto(self.state, extra=carry)
            if (shutdown is not None
                    and shutdown.should_preempt(start_epoch, epoch)):
                self._preempt(logger, checkpointer, epoch, journal,
                              shutdown)
            epoch += 1
            span_start = epoch

        if journal is not None:
            self._complete(logger, journal, start_epoch, loop_t0, last_asr)
        logger.finish()
        result = {"accuracies": logger.accuracies,
                  "epochs": logger.accuracies_epochs,
                  "final_weights": self.state.weights}
        if self.faults is not None:
            result["faults"] = fault_rows
        if self.async_spec is not None:
            result["async"] = async_rows
        if (self.traffic is not None and self.async_spec is None
                and self._placement is None):
            result["traffic"] = traffic_rows
        if backdoor:
            result["asr"] = asr
        return result

    @staticmethod
    def _host_records(pending):
        """The per-round 'fault' and 'async' records of a span, as host
        values, with one device-to-host read: the fault records' device
        counts (``quarantined``; in hierarchical rounds also
        ``shard_alive`` and ``shards_alive``), or the async rounds'
        counts, staleness histograms and weight masses, stacked and read
        at once.  Counts land as ints (a per-shard vector as a list of
        ints); the 'async' fields are the JAX engine's: counts as ints,
        the histogram and the weight mass as lists of floats."""
        fault = [f for f, _ in pending]
        rows = [a for _, a in pending]
        if rows[0] is None:
            keys = [k for k, v in fault[0].items()
                    if isinstance(v, torch.Tensor)]
            host = torch.stack([
                torch.cat([f[k].reshape(-1).long() for k in keys])
                for f in fault]).tolist()
            out = []
            for f, vals in zip(fault, host):
                rec, i = dict(f), 0
                for k in keys:
                    size = f[k].numel()
                    rec[k] = (int(vals[i]) if f[k].dim() == 0
                              else [int(v) for v in vals[i:i + size]])
                    i += size
                out.append((rec, None))
            return out
        host = torch.stack([
            torch.cat([a["counts"].float(), a["staleness_hist"].float(),
                       a["weight_mass"]]) for a in rows]).tolist()
        n, D = len(A.COUNT_NAMES), rows[0]["staleness_hist"].shape[0]
        out = []
        for f, a, vals in zip(fault, rows, host):
            rec = {"round": a["round"],
                   **{k: int(v) for k, v in zip(A.COUNT_NAMES, vals[:n])},
                   "staleness_hist": vals[n:n + D],
                   "weight_mass": vals[n + D:]}
            out.append((f, rec))
        return out

    def _complete(self, logger, journal, start_epoch, loop_t0, last_asr):
        """A journaled run's end: the 'lifecycle' complete and 'registry'
        events, the manifest's summary (trajectory endpoints, rounds/s,
        the event log's path, the config), ``journal.finish('done')`` and
        the run's entry appended to ``<run_dir>/index.jsonl``."""
        import dataclasses

        from attacking_federate_learning_tpu_torch.utils.lifecycle import (
            run_id_for
        )
        from attacking_federate_learning_tpu_torch.utils.registry import (
            RunRegistry
        )

        cfg = self.cfg
        rounds = int(self.state.round)
        logger.record(kind="lifecycle", phase="complete", round=rounds - 1,
                      attempt=journal.attempt)
        summary = {}
        if logger.jsonl_path:
            summary["events"] = os.path.abspath(logger.jsonl_path)
        loop_wall = time.perf_counter() - loop_t0
        if rounds > start_epoch and loop_wall > 0:
            summary["rounds_per_s"] = round(
                (rounds - start_epoch) / loop_wall, 4)
        if logger.accuracies:
            summary["final_accuracy"] = round(
                float(logger.accuracies[-1]), 4)
            summary["max_accuracy"] = round(float(max(logger.accuracies)),
                                            4)
        if last_asr is not None:
            summary["final_asr"] = round(last_asr, 4)
        logger.record(kind="registry", run_id=journal.run_id, rounds=rounds,
                      **summary)
        journal.finish("done", config=dataclasses.asdict(cfg),
                       config_hash=run_id_for(cfg).rsplit("_", 1)[-1],
                       **summary)
        journal.close()
        try:
            reg = RunRegistry(cfg.run_dir)
            reg.stamp(reg._entry_for_run(journal.run_id))
        except OSError as e:       # an unwritable index must not fail a
            logger.print(f"[registry] stamp failed: {e}")  # finished run
