"""Campaign specs: declarative sweep -> validated, identity-keyed cells.

The port's copy of the JAX package's ``campaigns/spec.py``.  A
:class:`CampaignSpec` is a ``base`` config, cartesian ``axes`` over
config fields (plus the pseudo-field ``attack``), and explicit ``cells``
overrides.  Expansion is deterministic (same spec, same cell ids in the
same order), and every cell is pre-validated against the engine's
composition-rejection matrix (:func:`composition_reject_reason`): an
invalid combination becomes a ``skipped`` cell carrying the rejection
message, never a crashed run.  One spec JSON expands in both packages
to the same cells in the same order, with the same skip verdicts and the
same grouping partition, except for what the port alone refuses: the
JAX field the port's config lacks (``backend``: a ``TypeError`` at
construction, so the cell is skipped with that message).

Cell identity is the config-hash ``run_id_for`` (utils/lifecycle.py)
extended with the attack name (:func:`cell_id_for`).  It hashes the
port's config, so a cell's id differs from the JAX package's, as run ids
do; the campaign id (:attr:`CampaignSpec.campaign_id`) hashes the spec
alone and is the same in both packages.

:func:`config_signature` is the grouping key: a hash over the config
fields that shape a cell's work, the JAX package's grouping key under a
name of its own.  ``epochs`` and the host-side io and cadence fields are
out.  The port's kernel libraries are keyed by their sources, not by the
config (ops/_build.py), so the grouping orders cells but does not decide
cache hits; the scheduler stamps the measured hit and miss counts into
the campaign manifest.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
from typing import Optional

from attacking_federate_learning_tpu_torch.config import ExperimentConfig
from attacking_federate_learning_tpu_torch.utils.lifecycle import (
    _IDENTITY_EXCLUDED, run_id_for
)


# Config fields that do not shape a cell's round and eval work: io
# paths, host-side cadence and thresholds, and the horizon (epochs only
# changes how many identical rounds run).
_GROUP_INERT = ("output", "log_dir", "run_dir", "data_dir",
              "checkpoint_every", "checkpoint_acc_threshold", "epochs")


def _hashed(d: dict) -> str:
    return hashlib.sha1(
        json.dumps(d, sort_keys=True, default=str).encode()).hexdigest()


def cell_id_for(cfg: ExperimentConfig, attack: str = "auto") -> str:
    """Deterministic cell identity: ``run_id_for`` for the reference
    attack resolution ('auto'), extended with the attack name
    otherwise — two attacks sharing a config (signflip vs alie) must
    not share a journal."""
    if attack in (None, "auto"):
        return run_id_for(cfg)
    d = dataclasses.asdict(cfg)
    for k in _IDENTITY_EXCLUDED:
        d.pop(k, None)
    d["attack"] = attack
    return (f"{cfg.dataset}_{cfg.defense}_{attack}_s{cfg.seed}_"
            f"{_hashed(d)[:10]}")


def config_signature(cfg: Optional[ExperimentConfig],
                     attack: str = "auto") -> str:
    """Grouping key (8 hex chars); 'invalid' for cells whose config never
    constructed."""
    if cfg is None:
        return "invalid"
    d = dataclasses.asdict(cfg)
    for k in _GROUP_INERT:
        d.pop(k, None)
    d["attack"] = attack
    return _hashed(d)[:8]


def apply_attack(overrides: dict, attack: str) -> dict:
    """The grid drivers' attack -> config mapping, shared: 'none'
    zeroes the malicious cohort (num_std and mal_prop, grid.py's
    historical behavior), the backdoor attacks need a trigger (default
    'pattern')."""
    out = dict(overrides)
    if attack == "none":
        out["num_std"] = 0.0
        out["mal_prop"] = 0.0
    elif attack in ("backdoor", "backdoor_timed"):
        if not out.get("backdoor"):
            out["backdoor"] = "pattern"
    return out


# ---------------------------------------------------------------------------
# the composition-rejection matrix, pre-validated

def _cohort(cfg) -> tuple:
    """(m, m_mal) under partial participation — the engine's static
    cohort math (core/engine.py.__init__), reproduced host-side."""
    n, f = cfg.users_count, cfg.corrupted_count
    if cfg.participation < 1.0:
        m = max(1, int(round(cfg.participation * n)))
        m_mal = min(int(round(cfg.participation * f)), m)
        if f > 0 and m_mal == 0:
            raise ValueError(
                f"participation={cfg.participation} rounds the "
                f"malicious cohort to 0 while f={f} — the attack "
                f"would silently never run (static cohorts); raise "
                f"participation or set mal_prop=0 explicitly")
        if m - m_mal > n - f:
            raise ValueError(
                f"cohort needs {m - m_mal} honest clients but only "
                f"{n - f} exist (n={n}, f={f}, "
                f"participation={cfg.participation})")
        return m, m_mal
    return n, f


def composition_reject_reason(overrides: dict,
                              attack: str = "auto") -> Optional[str]:
    """The engine's composition-rejection matrix as a pure pre-check.

    Returns None when the (config, attack) cell is constructible and
    passes every *pure* engine-init check — the same check functions
    the engine calls (defenses/kernels.py check_defense_args /
    check_tier2_args, core/faults.py check_fault_support,
    core/async_rounds.py check_async_support,
    core/population.py check_traffic_support) plus the config
    dataclass's own ``__post_init__`` rejections, a field the port's
    config lacks (``TypeError``) among them — or the rejection message
    otherwise.  tests/test_torch_port_campaign.py pins agreement between
    this pre-check and real construction over the known-invalid matrix,
    so the two can't drift silently; the executors still catch
    ValueError at cell start as the backstop for anything novel.
    """
    try:
        cfg = ExperimentConfig(**overrides)
    except (ValueError, TypeError) as e:
        return str(e)
    try:
        validate_composition(cfg, attack)
    except ValueError as e:
        return str(e)
    return None


def validate_composition(cfg: ExperimentConfig,
                         attack: str = "auto") -> None:
    """Raise ValueError for any (config, attack) the engine would
    reject at init (the pure checks only: nothing here touches a tensor
    or builds a model)."""
    from attacking_federate_learning_tpu_torch.defenses.kernels import (
        TIER2_DEFENSES, check_defense_args, check_tier2_args
    )

    m, m_mal = _cohort(cfg)
    timed = attack == "backdoor_timed"
    if attack in ("backdoor", "backdoor_timed") and not cfg.backdoor:
        raise ValueError(
            f"--attack {attack} requires a trigger: -b pattern|1|2|3 "
            f"(the poison set derives from it)")
    if timed and cfg.aggregation != "async":
        raise ValueError(
            "a timed attack (attacks/backdoor.py TimedBackdoorAttack) "
            "games the async arrival schedule; it requires "
            "aggregation='async' — under synchronous topologies there "
            "is no arrival time to game")
    if cfg.aggregation == "hierarchical":
        from attacking_federate_learning_tpu_torch.ops.federated import (
            tier1_assumed, tier2_assumed
        )

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
                # Mirrors engine._init_hierarchical: the pallas values
                # stay inside the scanned program and compose; only
                # the host kernels would pay a per-megabatch callback.
                raise ValueError(
                    f"hierarchical aggregation requires a device-"
                    f"resident {knob} ('xla' or 'pallas'; got 'host' — "
                    f"a host kernel would pure_callback once per "
                    f"megabatch per scan step)")
        S = cfg.users_count // cfg.megabatch
        f = cfg.corrupted_count
        t1 = (cfg.tier1_corrupted if cfg.tier1_corrupted is not None
              else tier1_assumed(f, S))
        t2 = (cfg.tier2_corrupted if cfg.tier2_corrupted is not None
              else tier2_assumed(f, cfg.megabatch))
        check_tier2_args(cfg.defense, cfg.megabatch, t1)
        check_tier2_args(cfg.tier2_defense or cfg.defense, S, t2)
        if cfg.mesh_shape is not None and cfg.mesh_shape[0] > 1:
            # The SPMD client map's schedule check, through the function
            # the engine's init calls (ops/federated.py spmd_schedule),
            # so the pre-check and the real refusal cannot drift: an S
            # the clients axis does not divide is a skipped cell, never
            # a crash.  Host-side numpy only.
            from attacking_federate_learning_tpu_torch.ops.federated import (
                make_placement, spmd_schedule
            )

            spmd_schedule(
                make_placement(cfg.users_count, f, cfg.megabatch,
                               cfg.mal_placement),
                cfg.mesh_shape[0])
    elif cfg.aggregation == "async":
        from attacking_federate_learning_tpu_torch.core.async_rounds import (
            check_async_support
        )

        check_async_support(cfg)
        if cfg.async_buffer > m:
            raise ValueError(
                f"--async-buffer {cfg.async_buffer} exceeds the cohort "
                f"(m={m}): the FedBuff trigger would never fire — the "
                f"pending pool holds at most one update per client")
        try:
            check_defense_args(cfg.defense, cfg.async_buffer, m_mal)
        except ValueError as e:
            raise ValueError(
                f"--aggregation async aggregates exactly "
                f"k=--async-buffer rows per applied round, so the "
                f"defense bound applies at n=k: {e}") from e
        if (cfg.defense == "TrimmedMean"
                and cfg.async_buffer - m_mal - 1 < 1):
            raise ValueError(
                f"--aggregation async TrimmedMean keeps k - f - 1 rows "
                f"per applied round; got k={cfg.async_buffer}, "
                f"f={m_mal} — raise --async-buffer")
    else:
        check_defense_args(cfg.defense, m, m_mal)
    if cfg.faults is not None and cfg.faults.enabled:
        from attacking_federate_learning_tpu_torch.core.faults import (
            check_fault_support
        )

        check_fault_support(cfg, cfg.participation)
    if cfg.traffic is not None and cfg.traffic.enabled:
        from attacking_federate_learning_tpu_torch.core.population import (
            check_traffic_support
        )

        check_traffic_support(cfg)


# ---------------------------------------------------------------------------
# the spec

@dataclasses.dataclass
class Cell:
    """One expanded campaign cell.  ``cfg`` is None when the config
    itself failed to construct (the skip reason says why)."""

    cell_id: str
    overrides: dict                      # merged base+axis+explicit
    attack: str = "auto"
    cfg: Optional[ExperimentConfig] = None
    priority: int = 0
    group: str = "invalid"               # config_signature
    skip: Optional[str] = None           # rejection message
    index: int = 0                       # spec expansion order

    def row(self) -> dict:
        """The stable descriptive fields stamped into journal records
        and the campaign manifest."""
        out = {"cell": self.cell_id, "attack": self.attack,
               "priority": self.priority, "group": self.group,
               "index": self.index}
        # The impl knobs ride along so `runs campaign` can render
        # impl-comparison tables straight from the journal rows, and
        # the topology knobs split the hierarchical cells.
        for k in ("dataset", "defense", "seed", "epochs", "aggregation",
                  "secagg", "aggregation_impl", "distance_impl",
                  "bulyan_selection_impl", "mesh_shape", "megabatch",
                  "mal_placement"):
            if self.cfg is not None:
                out[k] = getattr(self.cfg, k, None)
            elif k in self.overrides:
                out[k] = self.overrides[k]
        if isinstance(out.get("mesh_shape"), tuple):
            out["mesh_shape"] = list(out["mesh_shape"])  # JSONL-stable
        return out


@dataclasses.dataclass
class CampaignSpec:
    """Declarative sweep: ``base`` config kwargs, cartesian ``axes``
    (config fields + the pseudo-field 'attack'), explicit extra
    ``cells`` (each a dict of overrides; '_priority' rides along), and
    'field=value' -> int ``priorities`` rules (matching cells sum every
    matching rule; higher runs first)."""

    name: str = "campaign"
    base: dict = dataclasses.field(default_factory=dict)
    axes: dict = dataclasses.field(default_factory=dict)
    cells: list = dataclasses.field(default_factory=list)
    priorities: dict = dataclasses.field(default_factory=dict)
    deadline_s: float = 0.0
    order: str = "grouped"               # grouped | spec | shuffled

    # --- identity ---------------------------------------------------------
    def spec_hash(self) -> str:
        return _hashed({"base": self.base, "axes": self.axes,
                        "cells": self.cells})

    @property
    def campaign_id(self) -> str:
        return f"{self.name}_{self.spec_hash()[:10]}"

    # --- (de)serialization ------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1,
                          default=str)

    @classmethod
    def from_json(cls, text: str) -> "CampaignSpec":
        blob = json.loads(text)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(blob) - known
        if unknown:
            raise ValueError(
                f"unknown campaign-spec fields {sorted(unknown)} "
                f"(known: {sorted(known)})")
        return cls(**blob)

    @classmethod
    def load(cls, path: str) -> "CampaignSpec":
        with open(path) as f:
            return cls.from_json(f.read())

    # --- expansion --------------------------------------------------------
    def _priority_for(self, overrides: dict, attack: str,
                      explicit: Optional[int]) -> int:
        if explicit is not None:
            return int(explicit)
        prio = 0
        probe = dict(overrides, attack=attack)
        for rule, bump in self.priorities.items():
            if "=" not in rule:
                raise ValueError(
                    f"priority rule must be 'field=value', got {rule!r}")
            k, v = rule.split("=", 1)
            if str(probe.get(k)) == v:
                prio += int(bump)
        return prio

    def _make_cell(self, overrides: dict, attack: str,
                   explicit_priority: Optional[int], index: int) -> Cell:
        overrides = apply_attack(overrides, attack)
        skip = composition_reject_reason(overrides, attack)
        cfg = None
        try:
            cfg = ExperimentConfig(**overrides)
        except (ValueError, TypeError):
            pass                       # skip already carries the reason
        if cfg is not None:
            cell_id = cell_id_for(cfg, attack)
        else:
            probe = dict(overrides, attack=attack)
            cell_id = f"invalid_{_hashed(probe)[:10]}"
        return Cell(cell_id=cell_id, overrides=overrides, attack=attack,
                    cfg=cfg,
                    priority=self._priority_for(overrides, attack,
                                                explicit_priority),
                    group=config_signature(cfg, attack), skip=skip,
                    index=index)

    def expand(self) -> list:
        """Deterministic expansion: axes in insertion order, cartesian
        product in value order, explicit cells appended; duplicate
        cell ids are an error (two spellings of one config would race
        for one journal)."""
        cells, index = [], 0
        axis_names = list(self.axes)
        for combo in itertools.product(
                *(self.axes[a] for a in axis_names)) if axis_names else [()]:
            overrides = dict(self.base)
            overrides.update(dict(zip(axis_names, combo)))
            attack = overrides.pop("attack", "auto")
            cells.append(self._make_cell(overrides, attack, None, index))
            index += 1
        for extra in self.cells:
            overrides = dict(self.base)
            overrides.update(extra)
            prio = overrides.pop("_priority", None)
            attack = overrides.pop("attack", "auto")
            cells.append(self._make_cell(overrides, attack, prio, index))
            index += 1
        seen = {}
        for c in cells:
            if c.cell_id in seen:
                raise ValueError(
                    f"campaign {self.campaign_id}: duplicate cell id "
                    f"{c.cell_id} (indices {seen[c.cell_id]} and "
                    f"{c.index} expand to the same config+attack)")
            seen[c.cell_id] = c.index
        return cells


# ---------------------------------------------------------------------------
# cell -> CLI flags (the supervisor executor's child surface)

# ExperimentConfig field -> CLI flag for every value-typed field the
# port's flag surface exposes (cli.py:build_parser); the JAX package's
# --backend has no counterpart (--device does its job and is the
# executor's, not the cell's).
_VALUE_FLAGS = (
    ("dataset", "-s"), ("users_count", "-n"), ("mal_prop", "-m"),
    ("num_std", "-z"), ("defense", "-d"), ("model", "--model"),
    ("batch_size", "-c"), ("epochs", "-e"),
    ("learning_rate", "-l"), ("participation", "--participation"),
    ("local_steps", "--local-steps"), ("partition", "--partition"),
    ("dirichlet_alpha", "--dirichlet-alpha"),
    ("style_strength", "--style-strength"), ("seed", "--seed"),
    ("data_dir", "--data-dir"), ("log_dir", "--log-dir"),
    ("run_dir", "--run-dir"), ("synth_train", "--synth-train"),
    ("synth_test", "--synth-test"),
    ("data_placement", "--data-placement"),
    ("stream_prefetch", "--stream-prefetch"),
    ("stream_workers", "--stream-workers"),
    ("krum_scoring_method", "--krum-scoring-method"),
    ("bulyan_batch_select", "--bulyan-batch-select"),
    ("bulyan_selection_impl", "--bulyan-selection-impl"),
    ("bulyan_trim_impl", "--bulyan-trim-impl"),
    ("aggregation", "--aggregation"),
    ("aggregation_impl", "--aggregation-impl"),
    ("async_buffer", "--async-buffer"),
    ("async_max_staleness", "--async-max-staleness"),
    ("staleness_weight", "--staleness-weight"),
    ("megabatch", "--megabatch"), ("mal_placement", "--mal-placement"),
    ("secagg", "--secagg"), ("distance_impl", "--distance-impl"),
    ("distance_dtype", "--distance-dtype"),
    ("attack_direction", "--attack-direction"),
    ("dnc_iters", "--dnc-iters"), ("dnc_sketch_dim", "--dnc-sketch-dim"),
    ("dnc_filter_frac", "--dnc-filter-frac"),
    ("geomed_iters", "--geomed-iters"), ("geomed_eps", "--geomed-eps"),
    ("cclip_tau", "--cclip-tau"), ("cclip_iters", "--cclip-iters"),
    ("trimmed_mean_impl", "--trimmed-mean-impl"),
    ("median_impl", "--median-impl"),
    # The port's CLI also spells these (the JAX package's does not).
    ("test_step", "--test-step"), ("profile_every", "--profile-every"),
)
# Optional[value] fields: emitted only when set.
_OPTIONAL_FLAGS = (
    ("tier2_defense", "--tier2-defense"),
    ("tier1_corrupted", "--tier1-corrupted"),
    ("tier2_corrupted", "--tier2-corrupted"),
    ("output", "-o"),
)
# Boolean store_true flags.
_BOOL_FLAGS = (
    ("remat", "--remat"), ("krum_paper_scoring", "--krum-paper-scoring"),
    ("server_uses_faded_lr", "--server-uses-faded-lr"),
    ("log_round_stats", "--round-stats"), ("telemetry", "--telemetry"),
    ("margins", "--margins"), ("numerics", "--numerics"),
)
# TrafficConfig field -> CLI flag (the port's --traffic-* surface).
_TRAFFIC_FLAGS = (
    ("population", "--traffic-population"), ("rate", "--traffic-rate"),
    ("diurnal_amp", "--traffic-diurnal-amp"),
    ("diurnal_period", "--traffic-diurnal-period"),
    ("churn_dwell", "--traffic-churn-dwell"),
    ("latency_scale", "--traffic-latency-scale"),
    ("latency_tail", "--traffic-latency-tail"),
    ("sybil_burst_period", "--traffic-sybil-period"),
    ("sybil_burst_width", "--traffic-sybil-width"),
    ("fallback_defense", "--traffic-fallback"),
    ("min_cohort", "--traffic-min-cohort"),
)


def cfg_to_cli_args(cfg: ExperimentConfig, attack: str = "auto") -> list:
    """Express a cell as cli.py flags for the supervisor executor.

    Best-effort by construction (a handful of config fields have no
    CLI spelling — momentum, the shadow-train constants, grad_dtype);
    the scheduler therefore VERIFIES the round trip before launching:
    ``build_parser().parse_args(flags)`` -> ``config_from_args`` must
    reproduce the cell id, and a cell whose config is not expressible
    fails loudly instead of silently running a drifted config."""
    args = []
    for field, flag in _VALUE_FLAGS:
        args += [flag, str(getattr(cfg, field))]
    for field, flag in _OPTIONAL_FLAGS:
        v = getattr(cfg, field)
        if v is not None:
            args += [flag, str(v)]
    for field, flag in _BOOL_FLAGS:
        if getattr(cfg, field):
            args.append(flag)
    if cfg.checkpoint_every:
        # 0 (the config default) stays unspoken so the supervisor can
        # force its own resume-granularity default onto the child.
        args += ["--checkpoint-every", str(cfg.checkpoint_every)]
    bd = cfg.backdoor
    args += ["-b", "No" if bd is False else str(bd)]
    # The port's CLI has no --backdoor-staged (its config refuses the
    # staged path with a backdoor): backdoor_fused=False is not
    # expressible, and the round trip says so.
    if cfg.mesh_shape is not None:
        args += ["--mesh-shape", ",".join(str(x) for x in cfg.mesh_shape)]
    args += ["--augment", {None: "auto", True: "on",
                           False: "off"}[cfg.data_augment]]
    if cfg.faults is not None:
        f = cfg.faults
        args += ["--fault-dropout", str(f.dropout),
                 "--fault-straggler", str(f.straggler),
                 "--fault-straggler-delay", str(f.straggler_delay),
                 "--fault-corrupt", str(f.corrupt),
                 "--fault-corrupt-mode", f.corrupt_mode,
                 "--fault-shard-dropout", str(f.shard_dropout),
                 "--fault-shard-dropout-dwell",
                 str(f.shard_dropout_dwell)]
    if cfg.traffic is not None:
        t = cfg.traffic
        for field, flag in _TRAFFIC_FLAGS:
            args += [flag, str(getattr(t, field))]
        if t.seed is not None:
            args += ["--traffic-seed", str(t.seed)]
    if attack not in (None, "auto"):
        args += ["--attack", attack]
    return args


def verify_cli_round_trip(cell: Cell) -> Optional[str]:
    """Parse the cell's CLI spelling back into a config and compare
    identities; returns the problem string (None = exact).  Pure
    argparse: no torch op runs."""
    from attacking_federate_learning_tpu_torch.cli import (
        build_parser, config_from_args
    )

    args = cfg_to_cli_args(cell.cfg, cell.attack)
    try:
        ns = build_parser().parse_args(args)
        rebuilt = config_from_args(ns)
    except SystemExit:
        return f"cell {cell.cell_id}: CLI rejected flags {args}"
    got = cell_id_for(rebuilt, cell.attack)
    if got != cell.cell_id:
        deltas = {
            k: (v, getattr(rebuilt, k))
            for k, v in dataclasses.asdict(cell.cfg).items()
            if getattr(rebuilt, k, None) != v and k != "faults"}
        return (f"cell {cell.cell_id}: config not expressible via the "
                f"CLI flag surface (round-trip id {got}; field deltas "
                f"{deltas}) — fields without CLI flags (momentum, the "
                f"shadow-train constants, grad_dtype, ...) must stay at "
                f"their defaults under executor='supervisor'")
    return None
