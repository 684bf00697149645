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

The JAX package's engine knobs keep their values and refusals, and map
onto the port's one device suite, its hand-written kernels (the
counterpart of JAX's 'pallas' suite): ``distance_impl`` 'auto', 'xla'
or 'pallas', ``aggregation_impl`` 'xla' or 'pallas' and the 'xla' and
'pallas' values of ``bulyan_selection_impl``, ``bulyan_trim_impl``,
``trimmed_mean_impl`` and ``median_impl`` all run it, so a config is
accepted and refused exactly as the JAX package accepts and refuses it.
'host' runs a host engine (defenses/host.py, native/), and only where
the config names it: ``distance_impl`` Krum's winner or the whole of
Bulyan from the (m, d) matrix copied to the host each round,
``bulyan_selection_impl`` the hybrid exact selection (the distance
kernel's (m, m) matrix copied once, the native selection, the gather
and trim back on the card), ``bulyan_trim_impl``, ``trimmed_mean_impl``
and ``median_impl`` the native column-blocked kernels.  Nothing switches
to a host engine when a kernel fails: the failure raises.  'ring' and
'allgather' need the device mesh (below): Krum and Bulyan then take the
distance matrix of the blockwise schedule (parallel/distances.py).

Over a device mesh (``shardings``, a parallel/mesh.py ``MeshPlan``, or
one laid from ``cfg.mesh_shape``) the dataset is replicated to every
clients-axis position and the server state lives on the primary
(position (0, 0)).  A flat, async or traffic round's deliver deals the
cohort out to the clients positions, each computing its rows on its own
replicas at its copy of the weights, and gathers the (m, d) matrix to
the primary, where craft, aggregate and apply run as on one device.  A
hierarchical round over more than one clients position is the SPMD
client map (ops/federated.py): each position runs its own megabatches,
and the estimates gather to the primary for tier 2.

Where the mesh's model axis splits d (``MeshPlan.splits``), the server
state is held as column blocks on the model positions (the ``state``
property gathers it whole for whoever reads it: deliver once a round,
evaluation, checkpoints), the server step runs on each block, ALIE
crafts each block, and the flat, async and traffic rounds aggregate on
the blocks where the defense allows it (parallel/model_axis.py: the
coordinate-wise defenses per block, Krum and Bulyan from the Gram split
over d).  Under a mesh over the processes of a torch.distributed group
(parallel/mesh.py) the flat round runs with each process delivering its
positions' rows and the primary process aggregating, applying and
broadcasting the state; only the primary process writes logs and
checkpoints.

Under ``cfg.data_placement='host_stream'`` the training set stays in
host memory and each flat round's batch comes from a
:class:`~attacking_federate_learning_tpu_torch.data.stream.HostStream`
(pinned staging, a copy stream, ``stream_prefetch`` rounds ahead,
``stream_workers`` 1 for a worker thread); style and augmentation apply
after it arrives, the weights are byte-equal to device placement, and a
run ends with the JAX engine's 'stream' stall record.  Hierarchical,
async and traffic rounds refuse it with the JAX engine's messages.

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

The observatories (``cfg.telemetry``, ``margins``, ``numerics``,
``log_round_stats``; utils/margins.py, utils/numerics.py) ride every
round: the defense returns its diagnostics beside the aggregate (the
same selections and bits), the attack its envelope stats, the engine
adds the population stats, the stage health counters and the round
stats, all as device tensors in ``last_round_telemetry`` and
``last_round_stats``.  They join the fault, async and secagg records in
the one read at each host boundary and go out as the JAX engine's
'round', 'defense', 'attack', 'margin', 'numerics' and (hierarchical)
'shard_selection' events, and a 'selection_hist' at the end.  With the
four flags off no observatory code runs.

Every round runs in the six stage scopes of utils/costs.py (deliver,
quarantine, protect, tier1_aggregate, tier2_aggregate, apply) at the JAX
engine's sites; a scope costs nothing unless a profiler capture or a
count has armed it.  ``cfg.profile_every`` times each host boundary's
interval and captures every K-th one, booked onto the stages as 'wall'
events (utils/walls.py); :meth:`cost_report` counts each entry point on
a second engine loaded with the run's state, and :meth:`wire_ledger`
prices the protocol seams.

The beyond-reference defenses (DnC, GeoMedian, CenteredClip, FLTrust,
NormBound) take their constants from the config; DnC gets the round
index (``needs_round``: fresh sketches a round) and FLTrust the server's
gradient over the metadata pool (``needs_server_grad``), as in the JAX
engine.

With ``cfg.data_augment`` (by default on for CIFAR100 alone, the
reference's rule) the round's gathered batch is reflect-cropped and
flipped before deliver (data/augment.py), bit for bit the JAX package's
augmentation.  On the card every matmul and convolution runs in IEEE
fp32: resolving a CUDA device turns TF32 off for both, and cuDNN's
convolutions onto its deterministic algorithms, so a run on the card is
reproducible bit for bit.

Evaluation runs on the host's cadence, every ``test_step`` rounds and
after the last one (reference main.py:73-95), and prints the reference's
``Test set:`` lines; under a backdoor each is followed by the attack's
``##Test malicious net: [POST]`` line, and the run opens with the
``BEFORE:`` accuracy line instead of ``Starting Training...``.
"""

from __future__ import annotations

import contextlib
import copy
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
    CIFAR100, HOST_IMPL_KNOBS, MARGIN_DEFENSES, ExperimentConfig
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
from attacking_federate_learning_tpu_torch.data.stream import HostStream
from attacking_federate_learning_tpu_torch.defenses import (
    DEFENSES, check_defense_args
)
from attacking_federate_learning_tpu_torch.defenses.kernels import (
    TIER2_DEFENSES, check_tier2_args, population_telemetry
)
from attacking_federate_learning_tpu_torch.models.base import get_model
from attacking_federate_learning_tpu_torch.ops import federated as FD
from attacking_federate_learning_tpu_torch.parallel import distances as PD
from attacking_federate_learning_tpu_torch.parallel import model_axis as MA
from attacking_federate_learning_tpu_torch.parallel.mesh import (
    PerPosition, make_plan
)
from attacking_federate_learning_tpu_torch.protocols import secagg as SA
from attacking_federate_learning_tpu_torch.utils import threefry
from attacking_federate_learning_tpu_torch.utils.costs import (
    in_stage, stage_scope
)
from attacking_federate_learning_tpu_torch.utils.flatten import FlatParams
from attacking_federate_learning_tpu_torch.utils.margins import mean_as_xla
from attacking_federate_learning_tpu_torch.utils.metrics import RunLogger
from attacking_federate_learning_tpu_torch.utils.numerics import (
    nonfinite_count, norm_dynamic_range, row_norms
)
from attacking_federate_learning_tpu_torch.utils.profiling import (
    device_trace, synchronize
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _jsonable(v):
    """A host telemetry leaf as JSON: a scalar as a float, a vector as a
    list of floats, a matrix (the hierarchical (S, m) stacks) as nested
    lists, as the JAX engine writes them."""
    a = np.asarray(v)
    if a.ndim == 0:
        return float(a)
    if a.ndim == 1:
        return [float(x) for x in a]
    return a.astype(float).tolist()


class Observation:
    """One round's observatory record while the round runs: ``tele``, the
    telemetry tensors keyed as the JAX engine keys them (``attack_*``,
    ``margin_attack_*``, ``defense_*``, ``num_*``, ``shard_*``,
    ``tier2_*``, population stats), and the Krum winner for the round
    stats."""

    __slots__ = ("tele", "krum_selected")

    def __init__(self):
        self.tele = {}
        self.krum_selected = None


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist.  There is
    no silent fallback to the CPU: the caller asks for it by name.

    On a CUDA device this also turns TF32 off for cuBLAS matmuls and
    cuDNN convolutions (cuDNN's default is on), process-wide: the port
    computes in IEEE fp32, whoever calls it.  And it asks cuDNN for its
    deterministic convolution algorithms: the default backward of the
    CIFAR models accumulates with atomics, so two runs of one config
    parted by ulps within rounds, and a resumed or streamed run could not
    be bit for bit its twin."""
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
        torch.backends.cudnn.deterministic = True
    return dev


def _blockwise(fn, cond, a, b):
    """``fn(cond, a, b)``, on each column block where ``a`` and ``b`` are
    the model axis' blocks (``cond`` moved to each block's device)."""
    if not isinstance(a, PerPosition):
        return fn(cond, a, b)
    return PerPosition(fn(cond.to(x.device), x, y) for x, y in zip(a, b))


def _device_key(device) -> tuple:
    """A device as (type, index), a CUDA device without an index at the
    current one."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return ("cuda", torch.cuda.current_device())
    return (d.type, d.index)


class _Position:
    """One mesh position's own replicas (MeshPlan.place): the
    client-to-sample matrix, the training set, the style parameters, the
    megabatch grid, and the client step bound to a model on its
    device."""

    __slots__ = ("device", "shards", "train_x", "train_y", "style", "grid",
                 "client_update")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))


class _RoundEnv:
    """What one position's megabatches read in a hierarchical round: its
    replicas (``rep``; None on the sequential round, which reads the
    engine's own), its copy of the weights, its attack context, the id
    grid, and the round's fault masks and secagg tables on its device."""

    __slots__ = ("rep", "weights", "ctx", "grid", "masks", "dom", "keys",
                 "ids")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))


def _styled(xs: torch.Tensor, style, sel) -> torch.Tensor:
    """'femnist_style': row i of a batch becomes a_i xs_i + b_i, the style
    parameters ``(a, b)`` taken at the rows ``sel`` (None: all; a slice;
    or an index tensor); without style (None) the batch as it is."""
    if style is None:
        return xs
    a, b = style
    if sel is not None:
        a, b = a[sel], b[sel]
    shape = (xs.shape[0],) + (1,) * (xs.ndim - 1)
    return a.reshape(shape) * xs + b.reshape(shape)


def faded_lr(cfg: ExperimentConfig, t: int) -> float:
    """The round-t faded lr as the JAX round computes it with a traced
    round index: the Python product ``base_lr * fading_rate`` divided in
    float32 by ``t + fading_rate`` (reference server.py:50-52); an f32
    value."""
    return float(np.float32(cfg.learning_rate * cfg.fading_rate)
                 / (np.float32(t) + np.float32(cfg.fading_rate)))


class _Walls:
    """One run's measured walls (cfg.profile_every = K > 0): each eval
    interval is timed on the host clock from its first round to its
    boundary, where the card is synchronised once, and every K-th
    interval runs under a profiler capture (utils/profiling.py), written
    to ``<log_dir>/walltrace/r<epoch>`` and booked at the boundary.  A
    captured interval's host wall includes the capture's own cost."""

    def __init__(self, exp, logger, every: int):
        self.exp, self.logger, self.every = exp, logger, every
        self.interval = 0
        self.t0 = None
        self.trace_dir = None
        self.capture = None

    def open(self, epoch: int) -> None:
        """At a round: open the interval unless one is open."""
        if self.t0 is not None:
            return
        self.trace_dir = None
        if self.interval % self.every == 0:
            root = self.logger.log_dir or self.exp.cfg.log_dir
            self.trace_dir = os.path.join(root, "walltrace", f"r{epoch}")
        self.interval += 1
        self.capture = contextlib.ExitStack()
        self.capture.enter_context(device_trace(self.trace_dir,
                                                self.exp.device))
        self.t0 = time.perf_counter()

    def close(self, start: int, count: int) -> None:
        """At the boundary: synchronise, stop the capture, record the
        host wall of the ``count`` rounds from ``start``, book the
        capture."""
        exp = self.exp
        try:
            synchronize(exp.state.weights)
        finally:
            self.capture.close()
            self.capture = None
        wall = time.perf_counter() - self.t0
        self.t0 = None
        self.logger.record(
            kind="wall", source="host", name=exp._span_entry_name(),
            round=int(start), rounds=int(count), wall_s=round(wall, 6),
            rounds_per_s=round(count / wall, 4) if wall > 0 else 0.0)
        if self.trace_dir is not None:
            exp._book_span_walls(self.logger, self.trace_dir, count)

    def abort(self) -> None:
        """Stop a capture left open (the loop raised)."""
        if self.capture is not None:
            self.capture.close()
            self.capture = None
        self.t0 = None


class FederatedExperiment:
    """The FedSGD experiment of ``cfg`` (a flat, async or hierarchical
    round, ``cfg.aggregation``) on ``device`` (default ``cuda``).
    ``dataset`` defaults to ``load_dataset`` of the config; ``attacker``
    defaults to no attack."""

    def __init__(self, cfg: ExperimentConfig,
                 attacker: Optional[Attack] = None, dataset=None,
                 device="cuda", shardings=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        # Over a model axis that splits d the server state is held as
        # column blocks (the ``state`` property), and the flat round's
        # aggregation runs on the blocks where its defense allows it.
        self._model_split = False
        self._model_agg = None
        self._state = self._state_whole = None
        # The device mesh (parallel/mesh.py): the plan given, or one laid
        # from cfg.mesh_shape once the config has passed its checks
        # (:meth:`_init_mesh`); its clients-axis size decides the
        # topology's checks before that.
        self.shardings = shardings
        self._mesh_parts = (shardings.clients_parts if shardings is not None
                            else cfg.mesh_shape[0] if cfg.mesh_shape
                            else 1)
        self._hier_spmd = False
        self._reps = None
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
        # Secure aggregation (protocols/secagg.py; cfg.secagg): the config
        # refuses what it cannot compose with; a non-fusable attacker
        # handed in programmatically is refused here, as in the JAX
        # engine.
        self._secagg = None
        self.last_round_secagg = None
        if cfg.secagg != "off":
            if not getattr(self.attacker, "fusable", True):
                raise ValueError(
                    "--secagg masks inside the fused round program and "
                    "needs a fusable attack (drop --backdoor-staged)")
            self._secagg = cfg.secagg
            self._secagg_key = SA.secagg_key(cfg)
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
            F.check_fault_support(cfg, cfg.participation, self._mesh_parts)
        # Population & traffic (core/population.py): a lazy registry of
        # scalars, so memory scales with the cohort m, not the population.
        self.traffic = self.registry = None
        self._traffic_latency = None
        if cfg.traffic is not None and cfg.traffic.enabled:
            P.check_traffic_support(cfg, self._mesh_parts)
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
                self._traffic_fallback_fn = in_stage("tier1_aggregate")(
                    DEFENSES[cfg.traffic.fallback_defense])
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
        blockwise = (cfg.defense in ("Krum", "Bulyan")
                     and cfg.distance_impl in ("ring", "allgather"))
        if blockwise:
            self._check_blockwise()
        # The engine knobs: 'host' names a host engine; every other value
        # the device suite (defenses/kernels.py).
        host = {k: getattr(cfg, k) == "host" for k in HOST_IMPL_KNOBS}
        if cfg.defense == "Krum":
            # The fused distance -> score kernel under the cancellation
            # guard, exact sort over the distance kernel when it fails.
            defense = functools.partial(
                defense, method="fused",
                paper_scoring=cfg.krum_paper_scoring,
                distance_dtype=dist_dtype)
            if host["distance_impl"]:
                defense = functools.partial(defense, distance_impl="host")
        elif cfg.defense == "Bulyan":
            defense = functools.partial(
                defense, paper_scoring=cfg.krum_paper_scoring,
                distance_dtype=dist_dtype,
                batch_select=cfg.bulyan_batch_select)
            for knob, kwarg in (("distance_impl", "distance_impl"),
                                ("bulyan_selection_impl", "selection_impl"),
                                ("bulyan_trim_impl", "trim_impl")):
                if host[knob]:
                    defense = functools.partial(defense, **{kwarg: "host"})
        elif cfg.defense in ("TrimmedMean", "Median"):
            knob = ("trimmed_mean_impl" if cfg.defense == "TrimmedMean"
                    else "median_impl")
            if host[knob]:
                defense = functools.partial(defense, impl="host")
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
        if blockwise:
            defense = self._with_blockwise_distances(defense)
        self.defense_fn = in_stage("tier1_aggregate")(defense)
        self._init_observatories()
        self._init_mesh()

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
                self._tier2_fallback_fn = in_stage("tier2_aggregate")(
                    TIER2_DEFENSES[F.TIER2_FALLBACK])
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
        self.stream = None
        if cfg.data_placement == "host_stream":
            # The training set stays in host memory; each round's batch
            # is gathered there and copied ahead of its round
            # (data/stream.py), with the cohort of participants(t).
            self.shards = torch.from_numpy(shards).to(torch.int64)
            self.train_x = self.train_y = None
            self.stream = HostStream(
                self.dataset.train_x, self.dataset.train_y, shards,
                cfg.batch_size * cfg.local_steps, self.device,
                n_rounds=cfg.epochs, participants_fn=self.participants,
                prefetch=cfg.stream_prefetch, workers=cfg.stream_workers,
                plan=self.shardings)
        else:
            self.shards = torch.from_numpy(shards).to(self.device,
                                                      torch.int64)
            self.train_x = torch.from_numpy(self.dataset.train_x).to(
                self.device)
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
                                                    cfg.local_steps,
                                                    remat=cfg.remat)
        if self.shardings is not None:
            self._reps = self._place_replicas()
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

    @property
    def state(self) -> ServerState:
        """The server state, whole.  Over a model axis that splits d it is
        held as column blocks on the model positions (``_state``), and a
        read gathers them onto the primary, once a change."""
        st = self._state
        if st is not None and isinstance(st.weights, PerPosition):
            if self._state_whole is None:
                self._state_whole = self.shardings.whole_state(st)
            return self._state_whole
        return st

    @state.setter
    def state(self, st: ServerState) -> None:
        if self._model_split and not isinstance(st.weights, PerPosition):
            st = self.shardings.place_state(st)
        self._state = st
        self._state_whole = None

    def _init_observatories(self):
        """The observatories' plan (cfg.telemetry, margins, numerics,
        log_round_stats), the JAX engine's: the defense returns its
        diagnostics when telemetry or margins are on, or numerics on a
        margin-bearing defense (whose tie counters band the margins, so
        margins ride along and are filtered out of the events when
        --margins is off).  With all four off nothing here runs in a
        round."""
        cfg = self.cfg
        kernel_num = cfg.numerics and (
            cfg.aggregation == "hierarchical"
            or cfg.defense in MARGIN_DEFENSES)
        self._observing = (cfg.telemetry or cfg.margins or cfg.numerics
                           or cfg.log_round_stats)
        self._diag_kw = None
        if cfg.telemetry or cfg.margins or kernel_num:
            self._diag_kw = {"telemetry": True}
            if cfg.margins or kernel_num:
                self._diag_kw["margins"] = True
            if kernel_num:
                self._diag_kw["numerics"] = True
        # Krum under --round-stats alone: the winner from the defense's
        # own selection (one score evaluation), as the JAX engine's
        # pre-empted selection gives it; not under faults or traffic.
        self._select_kw = (
            {"telemetry": True}
            if (cfg.log_round_stats and self._diag_kw is None
                and cfg.defense == "Krum" and cfg.aggregation == "flat"
                and cfg.faults is None and cfg.traffic is None) else None)
        self.last_round_telemetry = None
        self.last_round_stats = None
        self._telemetry_winners = []

    def _keep_diag(self, key: str) -> bool:
        """The three-way filter: margin fields ride iff --margins, num_
        fields iff --numerics, everything else iff --telemetry."""
        cfg = self.cfg
        if key.startswith("margin_"):
            return cfg.margins
        if key.startswith("num_"):
            return cfg.numerics
        return cfg.telemetry

    def _begin_observation(self) -> Optional[Observation]:
        return Observation() if self._observing else None

    def _finish_telemetry(self, obs: Observation, grads, ddiag) -> None:
        """The defense's diagnostics into the round's telemetry, through
        the three-way filter, plus the population stats of the matrix the
        defense aggregated (--telemetry); under Krum the winner."""
        for k, v in ddiag.items():
            if self._keep_diag(k):
                obs.tele["defense_" + k] = v
        if self.cfg.telemetry:
            obs.tele.update(population_telemetry(grads))
        if (self.cfg.defense == "Krum" and self.async_spec is None
                and "selection_mask" in ddiag):
            obs.krum_selected = torch.argmax(
                ddiag["selection_mask"]).to(torch.int32)

    @in_stage("deliver")
    def _craft(self, grads: torch.Tensor, ctx, obs) -> torch.Tensor:
        """craft: the attack on the round's matrix.  With observation on,
        the attack's envelope stats before it (--telemetry), and its
        envelope utilization on the pre-attack copy and the crafted rows
        after it (--margins)."""
        if obs is None:
            if self._model_split and getattr(self.attacker, "columnwise",
                                             False):
                # Coordinate-wise (ALIE): each model position crafts its
                # own columns.
                plan = self.shardings
                return plan.all_gather_cols([
                    self.attacker.apply(b, self.m_mal, ctx)
                    for b in plan.split_cols(grads)])
            return self.attacker.apply(grads, self.m_mal, ctx)
        cfg, tele = self.cfg, obs.tele
        if cfg.telemetry:
            tele.update({"attack_" + k: v for k, v in
                         self.attacker.envelope_stats(
                             grads, self.m_mal, ctx).items()})
        # The attack writes its rows in place.
        pre = grads.clone() if cfg.margins else None
        crafted = self.attacker.apply(grads, self.m_mal, ctx)
        if cfg.margins:
            tele.update({"margin_attack_" + k: v for k, v in
                         self.attacker.margin_stats(
                             pre, self.m_mal, ctx, crafted=crafted).items()})
        return crafted

    @in_stage("deliver")
    def _wire_health(self, obs, grads, mask=None) -> None:
        """--numerics at the delivery seam: the crafted wire before any
        quarantine can hide a non-finite row, and its norm range."""
        if obs is not None and self.cfg.numerics:
            obs.tele["num_nonfinite_pre"] = nonfinite_count(grads)
            obs.tele["num_range_log2"] = norm_dynamic_range(grads, mask=mask)

    @in_stage("quarantine")
    def _post_health(self, obs, grads, mask=None) -> None:
        """--numerics after the quarantine: what the defense aggregates."""
        if obs is not None and self.cfg.numerics:
            obs.tele["num_nonfinite_post"] = nonfinite_count(grads, mask=mask)

    @in_stage("apply")
    def _end_observation(self, obs, norms, t: int, extra=None) -> None:
        """Close the round's record: the applied update's health
        (--numerics), the telemetry in ``last_round_telemetry`` and the
        round stats (--round-stats) in ``last_round_stats``: the
        gradient-norm mean/max/min of ``norms`` (per-client norms; None
        to leave them out), the update norm, the faded lr, ``extra``
        fields and under Krum the winner and whether it was malicious."""
        if obs is None:
            return
        cfg = self.cfg
        if cfg.numerics:
            obs.tele["num_nonfinite_agg"] = nonfinite_count(
                self.state.velocity)
        self.last_round_telemetry = (
            obs.tele if (cfg.telemetry or cfg.margins or cfg.numerics)
            else None)
        if not cfg.log_round_stats:
            return
        stats = {}
        if norms is not None:
            stats.update(grad_norm_mean=mean_as_xla(norms.reshape(-1), 0),
                         grad_norm_max=norms.max(),
                         grad_norm_min=norms.min())
        stats["update_norm"] = row_norms(self.state.velocity)
        stats["faded_lr"] = faded_lr(cfg, t)
        stats.update(extra or {})
        if obs.krum_selected is not None:
            sel = obs.krum_selected
            stats["krum_selected"] = sel
            stats["malicious_selected"] = (sel < self.m_mal).to(torch.int32)
        self.last_round_stats = stats

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
        config sets them) and each tier's validity bound.  A mesh whose
        clients axis holds more than one position switches the round onto
        the SPMD client map, its schedule checked now (S must divide by
        the clients axis)."""
        cfg = self.cfg
        if cfg.participation < 1.0:
            raise ValueError(
                "hierarchical aggregation requires full participation "
                "(placement assigns every client to a megabatch)")
        if cfg.data_placement != "device":
            raise ValueError(
                "hierarchical aggregation requires "
                "data_placement='device' (the scanned round gathers "
                "each megabatch's batch on device)")
        if cfg.backdoor and not cfg.backdoor_fused:
            raise ValueError(
                "hierarchical aggregation needs the fused backdoor "
                "path (drop --backdoor-staged)")
        if cfg.defense not in TIER2_DEFENSES:
            raise ValueError(
                f"hierarchical tier-1 defense must be one of "
                f"{sorted(TIER2_DEFENSES)} (the mask-aware kernel "
                f"set), got {cfg.defense!r}")
        if cfg.distance_impl in ("ring", "allgather", "host"):
            raise ValueError(
                f"hierarchical aggregation supports distance_impl in "
                f"auto/xla/pallas (got {cfg.distance_impl!r}): the "
                f"per-megabatch distance pass must stay inside the "
                f"scanned program")
        for knob in ("trimmed_mean_impl", "median_impl",
                     "bulyan_selection_impl", "bulyan_trim_impl"):
            if getattr(cfg, knob) == "host":
                raise ValueError(
                    f"hierarchical aggregation requires a device-"
                    f"resident {knob} ('xla' or 'pallas'; got 'host' — "
                    f"a host kernel would pure_callback once per "
                    f"megabatch per scan step)")
        if not getattr(self.attacker, "fusable", True):
            raise ValueError(
                "hierarchical aggregation needs a fusable attack: the "
                "client axis lives inside a scanned device program")
        place = FD.make_placement(self.n, self.f, cfg.megabatch,
                                  cfg.mal_placement)
        if self._mesh_parts > 1:
            FD.spmd_schedule(place, self._mesh_parts)
            self._hier_spmd = True
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
        self._tier2_fn = in_stage("tier2_aggregate")(
            TIER2_DEFENSES[self._tier2_name])
        # The crafted-rows NaN guard (the backdoor's), one flag a
        # megabatch on the device.
        self._check_attack_nan = (
            getattr(self.attacker, "checks_finite", False)
            and self.m_mal > 0
            and getattr(self.attacker, "num_std", 1) != 0)

    # --- the device mesh ----------------------------------------------------
    def _check_blockwise(self) -> None:
        """The JAX engine's checks of distance_impl 'ring' or 'allgather'
        under Krum or Bulyan: a device mesh, and a round cohort that the
        clients axis divides (the schedules deal even row blocks)."""
        impl = self.cfg.distance_impl
        if self.shardings is None and self.cfg.mesh_shape is None:
            raise ValueError(
                f"distance_impl={impl!r} needs a device mesh "
                f"— set mesh_shape (parallel/distances.py kernels are "
                f"shard_map programs over the clients axis)")
        p = self._mesh_parts
        if self.m % p != 0:
            raise ValueError(
                f"distance_impl={impl!r} needs the round cohort "
                f"divisible by the clients mesh axis (m={self.m}, "
                f"axis={p})")

    def _with_blockwise_distances(self, defense):
        """Krum or Bulyan over the blockwise distance matrix, the JAX
        engine's ``with_blockwise_D``: the round's matrix (in
        distance_dtype) is dealt back out to the positions, the ring or
        allgather schedule runs (parallel/distances.py), the (m, m)
        matrix comes back to the primary and the defense takes it
        through its ``D=`` seam."""
        dist_fn = {"ring": PD.pairwise_distances_ring,
                   "allgather": PD.pairwise_distances_allgather}[
                       self.cfg.distance_impl]
        dtype = _DTYPES[self.cfg.distance_dtype]

        def with_blockwise_D(grads, n, f, **kw):
            D = dist_fn(grads.to(dtype), self.shardings)
            return defense(grads, n, f, D=D, **kw)

        return with_blockwise_D

    def _init_mesh(self) -> None:
        """Lay the mesh of cfg.mesh_shape when no plan was given, over
        every visible card (over the engine's device when that is the
        CPU), once the config has passed its checks.  The primary
        position must be the engine's device, where the server state
        lives, and every position of its type; an attack bound to one
        device (the backdoor's poison set) needs every position there."""
        cfg = self.cfg
        if self.shardings is None and cfg.mesh_shape is not None:
            devices = None if self.device.type == "cuda" else [self.device]
            self.shardings = make_plan(tuple(cfg.mesh_shape), devices)
        if self.shardings is None:
            return
        plan = self.shardings
        if plan.group is not None:
            self._check_process_mesh(plan)
        if _device_key(plan.home) != _device_key(self.device):
            raise ValueError(
                f"the mesh's primary position is {plan.home}, the "
                f"engine's device is {self.device}: the server state lives "
                f"on the primary position")
        every = list(plan.mesh.devices.ravel())
        keys = {_device_key(d) for d in every}
        if any(k[0] != self.device.type for k in keys):
            raise ValueError(
                f"every mesh position must be a {self.device.type} device "
                f"like the engine's, got {list(map(str, every))}")
        if (len(keys) > 1
                and isinstance(getattr(self.attacker, "device", None),
                               torch.device)):
            raise ValueError(
                f"{type(self.attacker).__name__} keeps its state on "
                f"{self.attacker.device}; over a mesh of several devices "
                f"it needs every position on that device")

    def _check_process_mesh(self, plan) -> None:
        """A mesh over the processes of a torch.distributed group runs the
        flat round with the clients axis over the processes: each process
        delivers its positions' rows, the primary process aggregates,
        applies and broadcasts the state.  What else would need the group
        inside a round is refused, by name."""
        cfg = self.cfg
        what = []
        if cfg.aggregation == "hierarchical":
            what.append("the hierarchical round (its SPMD client map)")
        if cfg.aggregation == "async":
            what.append("the async buffered round")
        if self.traffic is not None:
            what.append("population traffic")
        if cfg.data_placement == "host_stream":
            what.append("data_placement='host_stream'")
        if cfg.distance_impl in ("ring", "allgather"):
            what.append(f"distance_impl={cfg.distance_impl!r} in a round")
        if not getattr(self.attacker, "fusable", True):
            what.append("a staged attack")
        if what:
            raise ValueError(
                f"a mesh over {plan.processes} processes runs the flat "
                f"round only; not supported over processes: "
                f"{', '.join(what)}")

    def _place_replicas(self) -> list:
        """Each position's own replicas (MeshPlan.place): the dataset
        and the client-to-sample matrix (host-resident under
        host_stream), the style parameters, the megabatch grid, and a
        client step on a model of the position's device.  The engine's
        own buffers become position 0's, and the server state is placed
        on the primary."""
        plan, cfg = self.shardings, self.cfg
        parts = plan.clients_parts
        # Over a model axis that splits d the server state goes out in
        # column blocks, and the flat round aggregates on them where its
        # defense allows (parallel/model_axis.py).
        self._model_split = plan.splits(self.flat.dim)
        self._model_agg = MA.split_defense(cfg, plan, self.flat.dim)
        # This process's first position (position 0 but in another
        # process of a group) takes the engine's own buffers.
        first = next(q for q in range(parts) if plan.local(q))
        if self.stream is None:
            shards, xs, ys, self.state = plan.place(
                self.shards, self.train_x, self.train_y, self.state)
            self.shards, self.train_x, self.train_y = (
                shards[first], xs[first], ys[first])
        else:
            shards = xs = ys = (None,) * parts
            self.state = plan.place_state(self.state)
        style = ((None,) * parts if self._style is None else
                 tuple(zip(*(plan.broadcast(v) for v in self._style))))
        grid = ((None,) * parts if self._placement is None
                else plan.broadcast(self._grid))
        if self._style is not None:
            self._style = style[first]
        if self._placement is not None:
            self._grid = grid[first]
        steps = {_device_key(self.device): self._client_update}
        reps = []
        for q, dev in enumerate(plan.positions):
            if not plan.local(q):
                reps.append(None)
                continue
            key = _device_key(dev)
            if key not in steps:
                steps[key] = make_client_update_fn(
                    copy.deepcopy(self.model).to(dev), self.flat,
                    cfg.local_steps, remat=cfg.remat)
            reps.append(_Position(device=dev, shards=shards[q],
                                  train_x=xs[q], train_y=ys[q],
                                  style=style[q], grid=grid[q],
                                  client_update=steps[key]))
        return reps

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
        return self._gather(t, self.shards, self.train_x, self.train_y,
                            self._rows(part))

    def _rows(self, part):
        """``part`` (host ids or a device tensor) as an int64 index on the
        engine's device; None stays None."""
        return (None if part is None else
                torch.as_tensor(part, dtype=torch.int64, device=self.device))

    def apply_style(self, xs: torch.Tensor, part):
        """'femnist_style': row i of the cohort batch becomes a_i xs_i +
        b_i; any other partition leaves it as it is.  ``part`` as for
        :meth:`gather_batches`."""
        return _styled(xs, self._style, self._rows(part))

    @in_stage("deliver")
    def compute_grads(self, t: int, part=None, position=None) -> torch.Tensor:
        """deliver: the cohort's (m, d) updates at the server weights of
        round t on the wire (grad_dtype): gradients, or with local steps
        the pseudo-gradients, on the round-t styled and augmented batch.
        ``part`` is the round's cohort (:meth:`participants`), drawn here
        when it is not given, or a megabatch's ids (an int64 device
        tensor, hierarchical rounds).

        Over a mesh each position computes its rows of the cohort on its
        own replicas and its copy of the weights, and the blocks gather
        to the primary in position order (:meth:`_deliver_split`); in the
        SPMD hierarchical round ``position`` (a :class:`_RoundEnv`) names
        the position whose replicas and weights a megabatch reads."""
        if position is not None:
            rep = position.rep
            xs, ys = self._gather(t, rep.shards, rep.train_x, rep.train_y,
                                  part)
            return self._client_step(t, xs, ys, part, rep.style,
                                     position.weights, rep.client_update)
        if part is None:
            part = self.participants(t)
        if self._reps is not None and self._placement is None:
            return self._deliver_split(t, part)
        if isinstance(part, np.ndarray):    # one host-to-device copy
            part = torch.from_numpy(part).to(self.device, torch.int64)
        if self.stream is not None:       # streamed: the cohort's batch
            xs, ys = self.stream.get(t)
        else:
            xs, ys = self.gather_batches(t, part)
        return self._client_step(t, xs, ys, part, self._style,
                                 self.state.weights, self._client_update)

    def _gather(self, t, shards, train_x, train_y, sel):
        """Round-t minibatches of the rows ``sel`` (None: all; a slice;
        or an index tensor on the buffers' device) of one set of
        buffers."""
        if sel is not None:
            shards = shards[sel]
        idx = round_batch_indices(
            shards, t, self.cfg.batch_size * self.cfg.local_steps)
        return train_x[idx], train_y[idx]

    def _client_step(self, t, xs, ys, sel, style, weights, client_update,
                     first: int = 0, total=None) -> torch.Tensor:
        """The client step on gathered (rows, k B, ...) batches on one
        device: the style of the rows ``sel`` (as for :meth:`_gather`),
        the round's augmentation (the draws of images ``[first, first +
        rows k B)`` of ``total``), the step at ``weights``, the wire
        dtype."""
        cfg = self.cfg
        rows = ys.shape[0]
        xs = _styled(xs, style, sel)
        if self.augment:
            xs = reflect_crop_flip(xs, round_augment_key(cfg.seed, t),
                                   first=first, total=total)
        k, B = cfg.local_steps, cfg.batch_size
        xs = xs.reshape((rows, k, B) + xs.shape[2:])
        ys = ys.reshape((rows, k, B))
        # Clients train at the faded lr the server dispatches; the
        # pseudo-gradient divides by the lr the server multiplies back.
        lr_train = torch.full((), faded_lr(cfg, t), dtype=torch.float32,
                              device=xs.device)
        lr_report = lr_train if cfg.server_uses_faded_lr else (
            cfg.learning_rate)
        grads = client_update(weights, xs, ys, lr_train, lr_report)
        return grads.to(self.grad_dtype).contiguous()

    def _deliver_split(self, t: int, part) -> torch.Tensor:
        """deliver over the mesh (the JAX engine's grads constrained
        over the clients axis): each position computes its rows of the
        cohort (``MeshPlan.row_bounds``, :meth:`_deliver_rows`) at its
        copy of the weights; the (m, d) matrix gathers to the primary."""
        plan = self.shardings
        weights = plan.broadcast(self.state.weights)
        streamed = self.stream.get(t) if self.stream is not None else None
        return plan.all_gather([
            self._deliver_rows(t, q, part, lo, hi, weights[q], streamed)
            if plan.local(q) else None
            for q, (lo, hi) in enumerate(plan.row_bounds(self.m))])

    def _deliver_rows(self, t: int, q: int, part, lo: int, hi: int,
                      weights, streamed) -> torch.Tensor:
        """Position q's rows ``[lo, hi)`` of the round-t cohort ``part``
        (host ids; None: every client) from its own replicas, or its
        block of the streamed batch, at ``weights``, its copy."""
        rep = self._reps[q]
        kb = self.cfg.batch_size * self.cfg.local_steps
        if part is None:
            sel = slice(lo, hi)
        elif isinstance(part, torch.Tensor):
            sel = part[lo:hi].to(rep.device, torch.int64, copy=True)
        else:
            sel = F.to_device(np.ascontiguousarray(part[lo:hi],
                                                   dtype=np.int64),
                              rep.device)
        if streamed is not None:
            xs, ys = streamed[0][q], streamed[1][q]
        else:
            xs, ys = self._gather(t, rep.shards, rep.train_x, rep.train_y,
                                  sel)
        return self._client_step(t, xs, ys, sel, rep.style, weights,
                                 rep.client_update, first=lo * kb,
                                 total=self.m * kb)

    @in_stage("quarantine")
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

    @in_stage("deliver")
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

    @in_stage("tier1_aggregate")
    def aggregate(self, grads: torch.Tensor, t: int, obs=None,
                  **kw) -> torch.Tensor:
        """tier1_aggregate: the configured defense over the round's
        matrix, with the seams it asks for: the round index
        (``needs_round``, DnC's fresh sketches) and the server gradient
        (``needs_server_grad``, FLTrust); ``kw`` carries ``mask`` and
        ``weights``.  With an :class:`Observation` the defense also
        returns its diagnostics, which go into ``obs``."""
        if self._needs_round:
            kw["round"] = t
        if self._needs_server_grad:
            kw["server_grad"] = self.server_grad()
        dkw = None if obs is None else (self._diag_kw or self._select_kw)
        if dkw is None and self._model_agg is not None:
            return self._model_agg(self.shardings, grads, self.m, self.m_mal,
                                   **kw)
        if dkw is None:
            return self.defense_fn(grads, self.m, self.m_mal, **kw)
        agg, ddiag = self.defense_fn(grads, self.m, self.m_mal, **kw, **dkw)
        if self._diag_kw is None:       # the winner only (--round-stats)
            obs.krum_selected = torch.argmax(
                ddiag["selection_mask"]).to(torch.int32)
        else:
            self._finish_telemetry(obs, grads, ddiag)
        return agg

    @in_stage("apply")
    def _apply(self, agg: torch.Tensor, t: int) -> ServerState:
        """apply: the momentum step on the aggregate, at the constant base
        lr on the server (reference server.py:89) unless
        server_uses_faded_lr."""
        cfg = self.cfg
        lr = (faded_lr(cfg, t) if cfg.server_uses_faded_lr
              else cfg.learning_rate)
        st = self._state
        if not isinstance(st.weights, PerPosition):
            return momentum_update(st, agg.float(), lr, cfg.momentum)
        # Over the model axis: the step on each column block, on its
        # position (per coordinate, so the bits of the whole step).
        if not isinstance(agg, PerPosition):
            agg = self.shardings.split_cols(agg.float())
        parts = [momentum_update(ServerState(w, v, st.round), a.float(), lr,
                                 cfg.momentum)
                 for w, v, a in zip(st.weights, st.velocity, agg)]
        return ServerState(PerPosition(p.weights for p in parts),
                           PerPosition(p.velocity for p in parts),
                           st.round + 1)

    @in_stage("apply")
    def _hold(self) -> ServerState:
        """A no-op round: weights and velocity stay bit for bit, the round
        counter advances."""
        st = self._state
        self.state = ServerState(st.weights, st.velocity, st.round + 1)
        return self.state

    def run_round(self, t: int) -> ServerState:
        if self.async_spec is not None:
            return self.run_async_round(t)
        if self._placement is not None:
            return self.run_hier_round(t)
        if self.traffic is not None:
            return self.run_traffic_round(t)
        obs = self._begin_observation()
        grads = self.compute_grads(t, self.participants(t))
        if grads is None:
            # Another process of a group than the primary's: its rows
            # are delivered; it receives the round's state.
            self.state = self.shardings.broadcast_state(self.state)
            return self.state
        grads = self._craft(grads, self.attack_context(t), obs)  # craft
        self._wire_health(obs, grads)
        # The round stats read the crafted matrix before the faults.
        crafted = grads if obs is not None else None
        mask = None
        if self.faults is not None:
            grads, mask = self.inject_and_quarantine(grads, t)
        if self._secagg is not None:
            grads = self.protect(grads, mask, t)               # protect
        self._post_health(obs, grads, mask)
        kw = {} if mask is None else {"mask": mask}
        agg = self.aggregate(grads, t, obs, **kw)              # aggregate
        self.state = self._apply(agg, t)                       # apply
        if self.shardings is not None and self.shardings.group is not None:
            self.state = self.shardings.broadcast_state(self.state)
        with stage_scope("apply"):
            self._end_observation(obs, self._client_norms(crafted), t)
        return self.state

    def _client_norms(self, grads):
        """Per-client update norms for the round stats (None when off)."""
        return (row_norms(grads) if grads is not None
                and self.cfg.log_round_stats else None)

    @in_stage("protect")
    def protect(self, grads: torch.Tensor, mask, t: int) -> torch.Tensor:
        """protect: vanilla secure aggregation between the quarantine and
        the (NoDefense) aggregation, the JAX engine's ``secagg_step``:
        every submitted row is masked in the uint32 bitcast domain, then
        recovered and verified server-side (protocols/secagg.py), with
        ``mask`` (the quarantine's) as the alive rows.  Returns the
        recovered matrix, bit for bit the clear one with the dead rows
        zeroed, and records the round's stats in ``last_round_secagg``.
        With a mask, the dead rows' pair masks (dropped or quarantined
        as non-finite) are re-derived every round."""
        recovered, stats = SA.secagg_cohort(grads, mask, self._secagg_key, t)
        self.last_round_secagg = {
            "round": t, **{k[len("secagg_"):]: v for k, v in stats.items()}}
        return recovered

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
        the same state.  The diagnostics (with observation on) are the
        configured defense's whatever the action, as in the JAX engine,
        so that defense also runs for them in 'fallback' and 'hold'
        rounds."""
        sched = self.traffic_plan(t, 1)
        self._traffic_events[t] = sched.events[0]
        action = int(sched.action[0])
        obs = self._begin_observation()
        grads = self.compute_grads(t, sched.shard_ids[0])      # deliver
        grads = self._craft(grads, self.attack_context(t), obs)  # craft
        self._wire_health(obs, grads)
        crafted = grads if obs is not None else None
        with stage_scope("quarantine"):
            mask = F.to_device(sched.arrived[0], self.device)
            grads = torch.where(mask[:, None], grads,
                                torch.zeros_like(grads))
            if self.faults is not None:
                grads, fmask = self.inject_and_quarantine(grads, t)
                mask = mask & fmask
        self._post_health(obs, grads, mask)
        if action == P.TRAFFIC_REMASK:
            agg = self.aggregate(grads, t, obs, mask=mask)
        else:
            if obs is not None and self._diag_kw is not None:
                self.aggregate(grads, t, obs, mask=mask)
            agg = (None if action == P.TRAFFIC_HOLD else
                   self._traffic_fallback_fn(grads, self.m, self.m_mal,
                                             mask=mask))
        self.state = self._hold() if agg is None else self._apply(agg, t)
        with stage_scope("apply"):
            self._end_observation(obs, self._client_norms(crafted), t)
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
        in ``last_round_faults``.

        Under groupwise secure aggregation each megabatch's rows go
        through the protocol (protocols/secagg.py), masks keyed on its
        global client ids, before its tier-1 (NoDefense) mean: the pair
        keys of all S groups are drawn on the host at once and cross in
        one copy, the per-group sum checks and pair counts land in (S,)
        device buffers, and the round's 'secagg' stats (the group sums'
        norms among them) go to ``last_round_secagg``.  With faults a
        group's alive rows are its undropped members (the JAX engine's
        ``qmask = ~drop``); a dead domain still runs its group's
        protocol.

        With the observatories on, each megabatch's tier-1 diagnostics
        (and in the clear modes its rows' norms) are kept and stacked
        (S, ...) after the loop; the tier-2 diagnostics always read the
        configured tier-2 defense, which also runs for them in
        'fallback' and 'hold' rounds (:meth:`_hier_telemetry`).

        Each megabatch returns what it produces (its estimate, into the
        (S, d) buffer, and its flags, counts, norms and diagnostics,
        stacked), and reads only its :class:`_RoundEnv`.  Over a mesh
        whose clients axis holds more than one position that is the
        SPMD client map (ops/federated.py): each position runs its own
        megabatches on its own replicas, its copy of the weights and its
        copies of the round's masks and tables, and the outputs gather to
        the primary, where tier 2 and the step run."""
        place, fc = self._placement, self.faults
        S, m, f1 = place.num_shards, place.megabatch, self._tier1_f
        plan = self.shardings if self._hier_spmd else None
        grid = self._grid
        if self.traffic is not None:
            self.last_round_slots = self.slot_ids(t)
            grid = F.to_device(self.last_round_slots, self.device)
        action = P.TRAFFIC_REMASK
        sec = self._secagg is not None
        obs = self._begin_observation()
        dkw = self._diag_kw if obs is not None else None
        # Per-client norms are server-visible in the clear modes only.
        want_norms = obs is not None and not sec and (
            self.cfg.telemetry or self.cfg.log_round_stats)
        tables = masks = dom = None
        if sec:
            with stage_scope("protect"):
                tables = SA.round_tables(
                    threefry.fold_in(self._secagg_key, t), place.grid,
                    self.device)
            drops = np.zeros(S, np.int64)
        if fc is not None:
            masks, dom, row = F.hier_round_faults(self._fault_key, t, place,
                                                  fc)
            action = int(F.plan_tier2_actions(
                [row["shards_alive"]], self._tier2_name, self._tier2_f)[0])
            if sec:
                drops = masks[:, 0].sum(1)
            with stage_scope("quarantine"):
                masks = F.to_device(masks, self.device)      # (S, 3, m)
                dom = F.to_device(dom, self.device)
        check_nan = self._check_attack_nan
        env = self._hier_env(t, plan, grid, masks, dom, tables,
                             check_finite=not check_nan)

        def shard_fn(sid, _ids, c, env):
            # The megabatch's ids on the position: the placement's, or the
            # round's resampled slots.  Its matrix is freed on return,
            # before the next megabatch's deliver.
            ids = env.grid[sid]
            grads = (self.compute_grads(t, ids) if env.rep is None
                     else self.compute_grads(t, ids, position=env))
            with stage_scope("deliver"):
                grads = self.attacker.apply(grads, c, env.ctx)   # craft
            dev = grads.device
            res, kw = {}, {}
            if check_nan:
                with stage_scope("quarantine"):
                    res["bad"] = (~torch.isfinite(grads[:c]).all() if c > 0
                                  else torch.zeros((), dtype=torch.bool,
                                                   device=dev))
            if sec:
                ok = torch.ones((), dtype=torch.int32, device=dev)
                pairs = torch.zeros((), dtype=torch.int32, device=dev)
                res["ok"], res["pairs"] = ok, pairs
                tab = (env.keys[sid], env.ids[sid])
            if fc is None:
                if sec:                                          # protect
                    grads, _ = SA.protect(grads, tab, ok=ok)
            else:
                with stage_scope("quarantine"):
                    slab = (self.fault_state["stale"][
                                t % fc.straggler_delay, sid]
                            if fc.straggler > 0 else None)
                    grads, drop = F.apply_shard_faults(
                        grads, env.masks[sid], slab, fc)
                if sec:
                    qmask = ~drop
                    grads, _ = SA.protect(grads, tab, qmask, ok=ok,
                                          count=pairs)
                    with stage_scope("quarantine"):
                        res["quar"] = (m - qmask.sum()).to(torch.int64)
                else:
                    with stage_scope("quarantine"):
                        grads, qmask, q = F.quarantine(grads, drop)
                        res["quar"] = q["quarantined"].to(torch.int64)
                with stage_scope("quarantine"):
                    res["alive"] = (qmask.sum() * env.dom[sid]).to(
                        torch.int64)
                kw["mask"] = qmask
            # Tier 1; with observation on, the rows' norms and its
            # diagnostics (filtered) go on the shard stacks.
            if want_norms:
                with stage_scope("deliver"):
                    res["norms"] = row_norms(grads)
            if dkw is None:
                res["est"] = self.defense_fn(grads, m, f1, **kw)
            else:
                res["est"], diag = self.defense_fn(grads, m, f1, **kw,
                                                   **dkw)
                res["diag"] = {k: v for k, v in diag.items()
                               if self._keep_diag(k)}
            return res

        # The megabatch loop's own work (the estimates' writes and the
        # gather) is tier 1's; the stages inside shard_fn are booked as
        # their own.
        with stage_scope("tier1_aggregate"):
            out = FD.client_map(shard_fn, place, env, with_sid=True,
                                out={"est": self._estimates}, plan=plan)
        est = out["est"]
        alive = out.get("alive")
        f2 = self._tier2_f
        agg = diag2 = None
        if fc is None:
            agg = FD.shard_reduce(self._tier2_fn, est, S, f2,     # tier 2
                                  **(dkw or {}))
            if dkw is not None:
                agg, diag2 = agg
        else:
            # A shard with no aggregable row has an undefined estimate;
            # tier 2's mask excludes it, and it is zeroed so nothing
            # non-finite can leak.
            with stage_scope("quarantine"):
                est.masked_fill_((alive == 0)[:, None], 0.0)
                self.last_round_faults = {
                    **{k: row[k] for k in ("round", "injected_dropout",
                                           "injected_straggler",
                                           "injected_corrupt")},
                    "quarantined": out["quar"].sum(),
                    "shards_dead": row["shards_dead"],
                    "shard_alive": alive,
                    "shards_alive": (alive > 0).sum(),
                    "tier2_action": action}
            # The diagnostics read the configured tier-2 defense whatever
            # the action (the JAX engine's); only the aggregate follows it.
            if dkw is not None:
                cfg_agg, diag2 = FD.shard_reduce(self._tier2_fn, est, S, f2,
                                                 alive_counts=alive, **dkw)
                if action == P.TRAFFIC_REMASK:
                    agg = cfg_agg
            elif action == P.TRAFFIC_REMASK:
                agg = FD.shard_reduce(self._tier2_fn, est, S, f2,
                                      alive_counts=alive)
            if action == P.TRAFFIC_FALLBACK:
                agg = FD.shard_reduce(self._tier2_fallback_fn, est, S, f2,
                                      alive_counts=alive)
        if sec:
            # The per-group sums are what the server sees (each estimate
            # is sum / m): their norms, dead shards' zeroed.  The squares
            # go through torch.sum, whose pairwise sum on the CPU keeps
            # the f32 norm within an ulp or two of XLA's (the CPU's
            # vector_norm is off by about 1e-6 at d = 79,510).
            dropped = int(drops.sum())
            with stage_scope("protect"):
                self.last_round_secagg = {
                    "round": t,
                    "sum_check_ok": (out["ok"] > 0).all().to(torch.int32),
                    "groups": S, "dropped": dropped,
                    "masks_reconstructed": out["pairs"].sum(),
                    "recovery": int(dropped > 0),
                    "group_sum_norms": est.square().sum(1).sqrt() * m}
                if obs is not None and self.cfg.telemetry:
                    # The envelope the server can still compute when
                    # groups, not clients, are what it sees.
                    self.last_round_secagg["group_cos_to_mean"] = (
                        SA.group_envelope_stats(est, m)[
                            "group_cos_to_mean"])
        if check_nan:
            with stage_scope("quarantine"):
                bad = bool(out["bad"].any())
            if bad:
                # The state stays at the last finished round.
                raise FloatingPointError(
                    "Got nan in backdoor shadow training")
        if obs is not None:
            self._hier_telemetry(obs, est, out.get("diag"),
                                 out.get("norms"), diag2)
        if agg is None:
            self._hold()
        else:
            self.state = self._apply(agg, t)                     # apply
        if obs is not None:
            with stage_scope("apply"):
                extra = None
                if sec:
                    gs = row_norms(est) * m
                    extra = {"group_sum_norm_mean": mean_as_xla(gs, 0),
                             "group_sum_norm_max": gs.max(),
                             "group_sum_norm_min": gs.min()}
                self._end_observation(
                    obs, out["norms"] if want_norms else None, t, extra)
        return self.state

    def _hier_env(self, t: int, plan, grid, masks, dom, tables,
                  check_finite: bool):
        """The hierarchical round's :class:`_RoundEnv`: on the sequential
        round the engine's own buffers and the round's attack context;
        under the SPMD map one env a position (a PerPosition), each with
        its replicas, its copy of the weights, an attack context on it
        and its copies of the round's masks and tables."""
        keys, ids = tables if tables is not None else (None, None)
        if plan is None:
            return _RoundEnv(
                weights=self.state.weights, grid=grid, masks=masks, dom=dom,
                keys=keys, ids=ids,
                ctx=self.attack_context(t, check_finite=check_finite))
        weights = plan.broadcast(self.state.weights)
        per = [plan.broadcast(v) for v in (masks, dom, keys, ids)]
        per = [(None,) * plan.clients_parts if v is None else v for v in per]
        lr = faded_lr(self.cfg, t)
        envs = []
        with stage_scope("deliver"):
            for q, rep in enumerate(self._reps):
                ctx = AttackContext(
                    original_params=weights[q],
                    learning_rate=torch.full((), lr, dtype=torch.float32,
                                             device=rep.device),
                    round=t, staleness=None, check_finite=check_finite)
                envs.append(_RoundEnv(
                    rep=rep, weights=weights[q], ctx=ctx, grid=rep.grid,
                    masks=per[0][q], dom=per[1][q], keys=per[2][q],
                    ids=per[3][q]))
        return PerPosition(envs)

    @in_stage("tier2_aggregate")
    def _hier_telemetry(self, obs, est, diag1, norms, diag2) -> None:
        """A hierarchical round's telemetry: the tier-1 diagnostics,
        stacked (S, ...), as ``shard_*`` (with --telemetry the rows'
        (S, m) norms as ``shard_grad_norms``), the tier-2 ones as
        ``tier2_*`` (and the estimates' norms as ``tier2_est_norms``),
        and with --numerics the health of the (S, d) estimate matrix tier
        2 reduces."""
        cfg, tele = self.cfg, obs.tele
        for k, v in (diag1 or {}).items():
            tele["shard_" + k] = v
        if norms is not None and cfg.telemetry:
            tele["shard_grad_norms"] = norms
        for k, v in (diag2 or {}).items():
            if self._keep_diag(k):
                tele["tier2_" + k] = v
        if cfg.telemetry:
            tele["tier2_est_norms"] = row_norms(est)
        if cfg.numerics:
            tele["num_nonfinite_post"] = nonfinite_count(est)
            tele["num_range_log2"] = norm_dynamic_range(est)

    def run_async_round(self, t: int) -> ServerState:
        """One buffered round (the JAX engine's ``async_core``): fresh
        updates into the ring, delivery, the attack on the delivered
        matrix, the staleness-weighted masked defense, and the momentum
        step only if a row was delivered.  Records the round's stats in
        ``last_round_async`` (and the injected fault counts in
        ``last_round_faults``)."""
        spec = self.async_spec
        obs = self._begin_observation()
        grads = self.compute_grads(t)                           # deliver
        # The ring is deliver's; its screen of the pending rows is
        # quarantine's (core/async_rounds.py).
        with stage_scope("deliver"):
            # The round stats read the computed cohort (what the clients
            # submitted this round); the delivered view is in 'async'.
            norms = self._client_norms(grads if obs is not None else None)
            dgrads, delivered, staleness, stats = A.async_step(
                grads, t, self._async_key, spec, self.async_state,
                self.m_mal, faults=self.faults,
                fkey=self._fault_key if self.faults is not None else None,
                latency=self._traffic_latency)
        if self.faults is not None:
            self.last_round_faults = {
                "round": t, **{k[len("fault_"):]: v for k, v in
                               stats.items() if k.startswith("fault_")}}
        # Craft at delivery; undelivered rows [0, f) get overwritten too,
        # so the matrix is masked again before the defense.
        crafted = self._craft(dgrads, self.attack_context(t, staleness), obs)
        self._wire_health(obs, crafted, delivered)
        with stage_scope("quarantine"):
            agg_grads = torch.where(delivered[:, None], crafted, 0.0)
        self._post_health(obs, agg_grads, delivered)
        with stage_scope("deliver"):
            weights = A.staleness_weights(staleness, delivered,
                                          spec.weighting)
            self.last_round_async = {
                "round": t, "counts": stats["counts"],
                "staleness_hist": stats["staleness_hist"],
                "weight_mass": A.weight_mass(staleness, delivered, weights,
                                             spec.depth),
                "delivered_mask": delivered, "staleness": staleness}
        kw = {} if weights is None else {"weights": weights}
        agg = self.aggregate(agg_grads, t, obs, mask=delivered, **kw)
        with stage_scope("apply"):
            upd = self._apply(agg, t)
            # An empty delivery is a server no-op: weights and velocity
            # hold, the round counter advances.
            any_del = delivered.any()
            st = self._state
            self.state = ServerState(
                _blockwise(torch.where, any_del, upd.weights, st.weights),
                _blockwise(torch.where, any_del, upd.velocity, st.velocity),
                upd.round)
            self._end_observation(obs, norms, t)
        return self.state

    # --- measured walls and the cost and wire ledgers -------------------
    def _span_entry_name(self) -> str:
        """The JAX engine's name for the span program its run dispatches
        for this configuration (its core/engine.py:_span_entry_name), the
        name a 'wall' event and its 'stage_cost' row share."""
        cfg = self.cfg
        hier = cfg.aggregation == "hierarchical"
        if self.async_spec is not None:
            return "async_span"
        if self.traffic is not None and not hier:
            return "traffic_span"
        if self.faults is not None:
            return "fault_span"
        if (cfg.telemetry or cfg.margins or cfg.numerics
                or self._secagg is not None):
            return "hier_tele_span" if hier else "tele_span"
        return "hier_span" if hier else "fused_span"

    def _round_entry_name(self) -> str:
        """The JAX engine's name for one round's entry point."""
        if self.async_spec is not None:
            return "async_round"
        if self._placement is not None:
            return "hier_round"
        if self.traffic is not None:
            return "traffic_round"
        return "fused_round"

    def wire_ledger(self) -> dict:
        """The bytes each protocol seam of this engine's topology moves a
        round (utils/costs.py:wire_ledger), from the config alone, as the
        JAX engine prices them: the expected secagg recovery load is the
        dropout rate over the cohort.  Under the SPMD client map the
        tier-1 -> tier-2 seam is the estimates' gather over the clients
        axis (``spmd_parts`` positions).  Over a model axis that splits d
        the Gram partials' and the state's gathers are priced too."""
        from attacking_federate_learning_tpu_torch.utils.costs import (
            wire_ledger
        )

        cfg = self.cfg
        num_shards = (self._placement.num_shards
                      if self._placement is not None else None)
        dropped = 0
        if cfg.secagg != "off" and self.faults is not None:
            dropped = int(round(self.faults.dropout * self.m))
        model = {}
        if self._model_split:
            model["model_parts"] = self.shardings.model_parts
            model["gram_rows"] = (MA.gram_rows(cfg, self.m)
                                  if self._model_agg is not None else 0)
        return wire_ledger(
            cohort=self.m, dim=self.flat.dim,
            grad_bytes=self.grad_dtype.itemsize,
            topology=cfg.aggregation, num_shards=num_shards,
            megabatch=cfg.megabatch if num_shards is not None else None,
            spmd_parts=self._mesh_parts if self._hier_spmd else 1,
            secagg=cfg.secagg, dropped=dropped,
            async_buffer=(cfg.async_buffer
                          if cfg.aggregation == "async" else None),
            **model)

    def _load_into(self, twin: "FederatedExperiment") -> None:
        """Copy what this engine's next round starts from into ``twin``,
        an engine of the same config and dataset: the server state, the
        carry state (through the checkpoint seam, from which a resumed run
        continues bit for bit), the traffic events not yet logged and a
        copy of the attacker.  Nothing of this engine is touched."""
        twin.state = twin._place_state(self._host_state())
        twin.restore_carry_state(self.carry_state_host())
        if self.traffic is not None:
            twin._traffic_events = dict(self._traffic_events)
        twin.attacker = copy.deepcopy(self.attacker)

    def cost_report(self, logger=None, span: Optional[int] = None):
        """The counted cost of every entry point of this engine under the
        JAX engine's names (utils/costs.py), each run once on a second
        engine of the same config and dataset loaded with this one's
        state (:meth:`_load_into`), the torch and numpy generators
        restored after, so that the run after it is byte for byte the run
        without it:

        - one round (``fused_round``, ``traffic_round``, ``async_round``
          or ``hier_round``) and one span (:meth:`_span_entry_name`) of
          ``span`` rounds (default: the eval interval, test_step rounds),
          from the current round;
        - ``compute_grads`` (one megabatch in hierarchical rounds),
          ``defense_<name>`` on its matrix (the round index and the
          server gradient as the round gives them), ``tier2_<name>`` on
          an (S, d) stand-in of the estimates, and ``eval``.

        Each becomes a CostRecord (FLOPs and bytes counted, their stage
        partition, each hand kernel's calls and modeled count, and on the
        card the allocator's peak above the start); with ``logger`` one
        'compile' event a kernel library built or loaded in this process
        (ops/_build.py), one 'cost' and one 'stage_cost' event an entry
        point and one 'wire_bytes' event.  An entry that fails lands in
        ``errors``; the rest of the table stands."""
        from attacking_federate_learning_tpu_torch.ops import _build
        from attacking_federate_learning_tpu_torch.utils.costs import (
            CompileLedger
        )

        cfg = self.cfg
        ledger = CompileLedger()
        t0 = int(self.state.round)
        span_len = int(span or max(1, min(cfg.test_step, cfg.epochs)))
        hier = self._placement is not None
        du_n, du_f = ((self._placement.megabatch, self._tier1_f) if hier
                      else (self.m, self.m_mal))
        np_rng = np.random.get_state()
        cuda = [self.device] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=cuda):
            twin = FederatedExperiment(cfg, self.attacker, self.dataset,
                                       device=self.device,
                                       shardings=self.shardings)
            part = twin._grid[0] if hier else None

            def rounds(count):
                def run():
                    for t in range(t0, t0 + count):
                        twin.run_round(t)
                return run

            self._load_into(twin)
            grads = twin.compute_grads(t0, part)
            kw = {}
            if self._needs_round:
                kw["round"] = t0
            if self._needs_server_grad:
                kw["server_grad"] = twin.server_grad()
            entries = [
                (self._round_entry_name(), rounds(1)),
                (self._span_entry_name(), rounds(span_len)),
                ("compute_grads", lambda: twin.compute_grads(t0, part)),
                (f"defense_{cfg.defense}",
                 lambda: twin.defense_fn(grads, du_n, du_f, **kw))]
            if hier:
                S = self._placement.num_shards
                est = grads.float().repeat(-(-S // du_n), 1)[:S]
                entries.append((f"tier2_{self._tier2_name}", lambda: (
                    FD.shard_reduce(twin._tier2_fn, est, S,
                                    self._tier2_f))))
            entries.append(("eval", lambda: twin.evaluate(
                twin.state.weights)))
            for name, thunk in entries:
                self._load_into(twin)
                try:
                    ledger.analyze(name, thunk, self.device)
                except Exception as e:      # noqa: BLE001 — one entry
                    # failing must not lose the rest of the table
                    ledger.errors.append((name, f"{type(e).__name__}: {e}"))
        np.random.set_state(np_rng)
        ledger.add_compiles(_build.COMPILES)
        ledger.wire = self.wire_ledger()
        if logger is not None:
            ledger.emit(logger)
        self.cost_ledger = ledger
        return ledger

    # --- carry state and rollback ---------------------------------------
    def _host_state(self) -> ServerState:
        """Owned host copies of the server state."""
        st = self.state
        return ServerState(st.weights.to("cpu", copy=True).numpy(),
                           st.velocity.to("cpu", copy=True).numpy(),
                           int(st.round))

    def _place_state(self, st: ServerState) -> ServerState:
        """A host (or any-device) server state as fresh f32 tensors on the
        engine's device (over a mesh: MeshPlan.place_state, the primary
        position)."""
        if self.shardings is not None:
            return self.shardings.place_state(st)

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
            log: Optional[Callable[[str], None]] = None,
            timer=None) -> dict:
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

        ``timer``: a utils.profiling.PhaseTimer; each round and each
        evaluation is timed, synchronised with the card (phases 'round'
        and 'eval'), and its summary is the 'profile' event at the end.

        With ``cfg.profile_every`` K > 0 every eval interval is timed on
        the host clock at its boundary (one synchronisation, a 'wall'
        event with source='host', rounds and rounds/s; each evaluation
        too, name 'eval'), and every K-th interval runs under a profiler
        capture written to ``<log_dir>/walltrace/r<epoch>`` and booked
        onto the stage taxonomy as a source='trace' 'wall' event
        (utils/walls.py; the records also in ``wall_records``).  A
        booking that fails prints ``[walls] booking failed`` and the run
        goes on.

        Returns ``accuracies`` and ``epochs`` (this attempt's
        evaluations), ``final_weights``, and with faults ``faults`` (one
        dict of counts per round run in this attempt, a rolled-back
        round again when it is run again), in async rounds ``async`` (the
        'async' event of each round run in this attempt), in flat traffic
        rounds ``traffic`` (the 'traffic' event of each round run in this
        attempt), under a backdoor ``asr`` (the attack success rate at
        each evaluation)."""
        if self.shardings is not None and not self.shardings.is_primary:
            # Only the primary process of a group writes logs and
            # checkpoints.
            checkpointer = journal = None
            if logger is None and log is None:
                log = []
        own = logger is None and log is None
        if logger is None:
            logger = (RunLogger(self.cfg, self.cfg.output, self.cfg.log_dir)
                      if own else RunLogger(self.cfg, log_dir=None, log=log))
        with contextlib.ExitStack() as stack:
            if own:
                stack.enter_context(logger)
            return self._run_body(logger, checkpointer, journal, shutdown,
                                  timer)

    def _book_span_walls(self, logger, trace_dir: str, count: int):
        """Book one interval's capture onto the stage taxonomy and record
        its 'wall' event (source='trace').  Returns the WallRecord, or
        None when the capture wrote no trace or the booking failed:
        the walls must never sink the run they measure."""
        from attacking_federate_learning_tpu_torch.utils.walls import (
            book_trace
        )

        try:
            rec = book_trace(trace_dir, name=self._span_entry_name(),
                             platform=self.device.type, rounds=count)
        except Exception as e:          # noqa: BLE001 — observability
            logger.print(f"[walls] booking failed: "
                         f"{type(e).__name__}: {e}")
            return None
        if rec is not None:
            self.wall_records.append(rec)
            logger.record(**rec.wall_event())
        return rec

    def _run_body(self, logger, checkpointer, journal, shutdown,
                  timer=None) -> dict:
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
        fault_rows, async_rows, traffic_rows, secagg_rows, pending, asr = (
            [], [], [], [], [], [])
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

        def timed(name, sync=None):
            if timer is None:
                return contextlib.nullcontext()
            return timer.phase(name,
                               sync_on=sync or (lambda: self.state.weights))

        # The measured walls (cfg.profile_every): off, none of this runs.
        self.wall_records = []
        walls = (_Walls(self, logger, int(cfg.profile_every))
                 if cfg.profile_every > 0 else None)
        loop_t0 = time.perf_counter()
        rounds_pending = []
        try:
            while epoch < cfg.epochs:
                if walls is not None:
                    walls.open(epoch)
                with timed("round"):
                    self.run_round(epoch)
                if (self.faults is not None or self.async_spec is not None
                        or self._secagg is not None or self._observing):
                    pending.append((self.last_round_faults,
                                    self.last_round_async,
                                    self.last_round_secagg,
                                    self.last_round_telemetry,
                                    self.last_round_stats))
                    rounds_pending.append(epoch)
                is_eval = epoch % cfg.test_step == 0 or epoch == cfg.epochs - 1
                if not (is_eval or (ckpt_every and epoch % ckpt_every == 0)):
                    epoch += 1
                    continue
                # A host boundary: where the JAX engine's span ends.
                if walls is not None:
                    walls.close(span_start, epoch - span_start + 1)
                if pending:
                    recs = self._host_records(pending)
                    for t_rec, (frow, arow, srow, tele, rstats) in zip(
                            rounds_pending, recs):
                        if frow is not None:
                            fault_rows.append(frow)
                        if arow is not None:
                            async_rows.append(arow)
                        if srow is not None:
                            secagg_rows.append(srow)
                        if fresh(t_rec):
                            if rstats is not None:
                                logger.record(kind="round", round=t_rec,
                                              **rstats)
                            if frow is not None:
                                logger.record(kind="fault", **frow)
                            if arow is not None:
                                logger.record(kind="async", **arow)
                            if srow is not None:
                                logger.record(kind="secagg", **srow)
                            if tele is not None:
                                self._emit_round_telemetry(logger, t_rec, tele)
                        if cfg.log_round_stats and self.traffic is not None:
                            # Round by round, as the JAX engine's per-round
                            # path emits them under --round-stats.
                            ev = self._traffic_events.pop(t_rec, None)
                            if ev is not None:
                                traffic_rows.append(ev)
                                if fresh(t_rec):
                                    logger.record(kind="traffic", **ev)
                    pending, rounds_pending = [], []
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
                    t_eval = time.perf_counter()
                    with timed("eval", lambda: correct):
                        test_loss, correct = self.evaluate(self.state.weights)
                    if walls is not None:
                        synchronize((test_loss, correct))
                        logger.record(kind="wall", source="host", name="eval",
                                      round=int(epoch), wall_s=round(
                                          time.perf_counter() - t_eval, 6))
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
        finally:
            if walls is not None:
                walls.abort()     # a capture left open by a raise

        if cfg.telemetry:
            self._emit_selection_hist(logger)
        if timer is not None:
            logger.record(kind="profile", phases=timer.summary())
        if self.stream is not None:
            # Did the host gather and copy sit on the round path?
            logger.record(kind="stream", **self.stream.stall_stats())
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
        if self._secagg is not None:
            result["secagg"] = secagg_rows
        if (self.traffic is not None and self.async_spec is None
                and self._placement is None):
            result["traffic"] = traffic_rows
        if backdoor:
            result["asr"] = asr
        return result

    @staticmethod
    def _host_records(pending):
        """The per-round records of a span as host values, with one
        device-to-host read.  ``pending`` holds one tuple a round,
        ``(fault, async, secagg[, telemetry, round_stats])``, each a dict
        or None: the fault and secagg records' device counts (in
        hierarchical rounds the per-shard vector; the groupwise sums'
        norms), the async records' counts, staleness histograms and
        weight masses, and the observatories' telemetry and round stats,
        all read at once.  Returns tuples as wide as the given ones.
        Fault and secagg counts land as ints (a vector as a list), their
        float tensors as floats; the 'async' fields are the JAX engine's
        (counts as ints, the histogram and the weight mass as lists of
        floats); telemetry and round stats as the JAX engine writes them
        (:func:`_jsonable`: every number a float, a matrix as nested
        lists)."""
        async_fields = ("counts", "staleness_hist", "weight_mass")

        def tensors_of(j, r):
            if r is None:
                return []
            if j == 1:
                return [(k, r[k]) for k in async_fields]
            return [(k, v) for k, v in r.items()
                    if isinstance(v, torch.Tensor)]

        parts = [v.reshape(-1).double() for p in pending
                 for j, r in enumerate(p) for _, v in tensors_of(j, r)]
        flat = torch.cat(parts).tolist() if parts else []
        out, i = [], 0
        for p in pending:
            recs = []
            for j, r in enumerate(p):
                if r is None:
                    recs.append(None)
                    continue
                vals = {}
                for k, v in tensors_of(j, r):
                    vals[k] = (v, flat[i:i + v.numel()])
                    i += v.numel()
                if j == 1:
                    counts = vals["counts"][1]
                    rec = {"round": r["round"],
                           **{k: int(c) for k, c in
                              zip(A.COUNT_NAMES, counts)},
                           "staleness_hist": [
                               float(x) for x in vals["staleness_hist"][1]],
                           "weight_mass": vals["weight_mass"][1]}
                elif j >= 3:
                    rec = {k: _jsonable(np.reshape(vals[k][1],
                                                   vals[k][0].shape)
                                        if k in vals else v)
                           for k, v in r.items()}
                else:
                    rec = dict(r)
                    for k, (v, x) in vals.items():
                        kind = float if v.is_floating_point() else int
                        rec[k] = (kind(x[0]) if v.dim() == 0
                                  else [kind(y) for y in x])
                recs.append(rec)
            out.append(tuple(recs))
        return out

    def _shard_static_fields(self):
        """The placement's ground truth every 'shard_selection' event
        carries: the defenses of both tiers, the megabatch, each shard's
        malicious-row count, the placement and the assumed bounds."""
        pl = self._placement
        return {"defense": self.cfg.defense,
                "tier2_defense": self._tier2_name,
                "megabatch": pl.megabatch,
                "mal_counts": [int(c) for c in pl.mal_counts],
                "mal_placement": self.cfg.mal_placement,
                "tier1_corrupted": self._tier1_f,
                "tier2_corrupted": self._tier2_f}

    def _emit_round_telemetry(self, logger, t: int, tele: dict) -> None:
        """One round's telemetry (host values, keyed as the JAX engine
        keys them) as its events: one schema-v12 'margin' event
        (--margins: the defense's margin fields, their colluder-survival
        rollups, the attack's envelope utilization, the hierarchical
        stacks with their rollups, and under traffic the round's f_eff),
        one schema-v14 'numerics' event (--numerics: the stage counters,
        the defense's tie and cancellation counters, their rollups), and
        with --telemetry the 'shard_selection' (hierarchical), 'defense'
        and 'attack' events; the Krum winner is kept for the end-of-run
        'selection_hist'."""
        from attacking_federate_learning_tpu_torch.utils import margins as M
        from attacking_federate_learning_tpu_torch.utils import (
            numerics as N
        )

        defense_fields, attack_fields, shard_fields = {}, {}, {}
        margin_fields, margin_attack, hier_margin = {}, {}, {}
        numerics_fields = {}
        for k, val in tele.items():
            # The margin and numerics prefixes first: 'defense_margin_*',
            # 'shard_num_*' ... would otherwise fall in the branches
            # below.
            if k.startswith("defense_margin_"):
                margin_fields[k[len("defense_"):]] = val
            elif k.startswith("margin_attack_"):
                margin_attack[k[len("margin_attack_"):]] = val
            elif k.startswith(("shard_margin_", "tier2_margin_")):
                hier_margin[k] = val
            elif k.startswith("defense_num_"):
                numerics_fields[k[len("defense_num_"):]] = val
            elif k.startswith(("shard_num_", "tier2_num_")):
                tier, rest = k.split("num_", 1)
                numerics_fields[tier + rest] = val
            elif k.startswith("num_"):
                numerics_fields[k[len("num_"):]] = val
            elif k.startswith("attack_"):
                attack_fields[k[len("attack_"):]] = val
            elif k.startswith(("shard_", "tier2_")):
                shard_fields[k] = val
            elif k.startswith("defense_"):
                defense_fields[k[len("defense_"):]] = val
            else:
                defense_fields[k] = val         # population stats
        cfg = self.cfg
        if cfg.margins and (margin_fields or margin_attack or hier_margin):
            ev = dict(margin_fields)
            ev.update(M.margin_rollups(margin_fields, self.m_mal))
            for mk, mv in margin_attack.items():
                ev["attack_" + mk] = mv
            if hier_margin:
                ev.update(hier_margin)
                shard_stacks = {k[len("shard_"):]: v
                                for k, v in hier_margin.items()
                                if k.startswith("shard_margin_")}
                tier2_fields = {k[len("tier2_"):]: v
                                for k, v in hier_margin.items()
                                if k.startswith("tier2_margin_")}
                counts = list(self._placement.mal_counts)
                if shard_stacks:
                    for rk, rv in M.hier_margin_rollups(
                            shard_stacks, counts).items():
                        ev["shard_" + rk] = rv
                if tier2_fields:
                    for rk, rv in M.tier2_margin_rollups(
                            tier2_fields, [c > 0 for c in counts]).items():
                        ev["tier2_" + rk] = rv
            if self.traffic is not None:
                tr = self._traffic_events.get(int(t))
                if tr is not None and "f_eff" in tr:
                    ev["f_eff"] = int(tr["f_eff"])
            logger.record(kind="margin", round=int(t), defense=cfg.defense,
                          malicious_count=self.m_mal, **ev)
        if cfg.numerics and numerics_fields:
            nev = dict(numerics_fields)
            nev.update(N.numerics_rollups(numerics_fields))
            logger.record(kind="numerics", round=int(t),
                          defense=cfg.defense,
                          tie_band_ulps=N.TIE_BAND_ULPS, **nev)
        if not cfg.telemetry:
            return
        if shard_fields:
            logger.record(kind="shard_selection", round=int(t),
                          **self._shard_static_fields(), **shard_fields)
        if defense_fields:
            logger.record(kind="defense", round=int(t), defense=cfg.defense,
                          malicious_count=self.m_mal, **defense_fields)
        if attack_fields:
            logger.record(kind="attack", round=int(t),
                          attack=self.attacker.name, **attack_fields)
        mask = defense_fields.get("selection_mask")
        if mask is not None and cfg.defense == "Krum":
            self._telemetry_winners.append(
                int(max(range(len(mask)), key=mask.__getitem__)))

    def _emit_selection_hist(self, logger) -> None:
        """The end-of-run 'selection_hist' event of the Krum winners
        (--telemetry): per-client counts, the distinct winners, the top
        client's share and the malicious picks."""
        import collections

        wins = self._telemetry_winners
        if not wins:
            return
        counts = collections.Counter(wins)
        top1_client, top1 = counts.most_common(1)[0]
        logger.record(
            kind="selection_hist", defense=self.cfg.defense,
            counts={str(k): v for k, v in sorted(counts.items())},
            rounds=len(wins), distinct_winners=len(counts),
            top1_share=round(top1 / len(wins), 4),
            top1_client=top1_client,
            malicious_picks=sum(1 for w in wins if w < self.m_mal))

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
