"""Experiment configuration of the flat FedSGD round.

A flat-only subset of the JAX package's ``ExperimentConfig``: the fields
the flat, synchronous round reads, partial participation, local steps,
the bf16 wire and the selection knobs among them, with the same
defaults, the same derived values (``corrupted_count``, ``'auto'`` z,
per-dataset fading rate, the dataset's default model, the ``-b``
coercion) and the same validation messages (the model/dataset family
check among them), plus the JAX package's ``FaultConfig`` (a copy: the
port imports nothing of the JAX package), the run lifecycle's fields and
the asynchronous buffered round's (``aggregation='async'``,
``async_buffer``, ``async_max_staleness``, ``staleness_weight``), the
beyond-reference defenses' constants (``dnc_*``, ``geomed_*``,
``cclip_*``) and the population & traffic model (``TrafficConfig``, a
copy of the JAX package's), and the hierarchical two-tier round's
(``aggregation='hierarchical'``, ``megabatch``, ``tier2_defense``,
``mal_placement``, ``tier1_corrupted``, ``tier2_corrupted``).  The
device mesh (``mesh_shape``, the SPMD client map), host streaming,
secagg and the observability knobs are later slices of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


MNIST = "MNIST"
CIFAR10 = "CIFAR10"
CIFAR100 = "CIFAR100"
SYNTH_MNIST = "SYNTH_MNIST"            # MNIST-shaped deterministic synthetic
SYNTH_CIFAR10 = "SYNTH_CIFAR10"        # CIFAR10-shaped deterministic synthetic
SYNTH_MNIST_HARD = "SYNTH_MNIST_HARD"  # low-SNR variant for behavioral tests
SYNTH_CIFAR10_HARD = "SYNTH_CIFAR10_HARD"  # low-SNR CIFAR-shaped variant

# The JAX CLI's -s choices, in its order.
DATASETS = (MNIST, CIFAR10, CIFAR100, SYNTH_MNIST, SYNTH_CIFAR10,
            SYNTH_MNIST_HARD, SYNTH_CIFAR10_HARD)

# Per-dataset LR fading constants (reference main.py:144-149).
FADING_RATES = {CIFAR10: 2000.0, MNIST: 10000.0, CIFAR100: 1500.0,
                SYNTH_MNIST: 10000.0, SYNTH_CIFAR10: 2000.0,
                SYNTH_MNIST_HARD: 10000.0, SYNTH_CIFAR10_HARD: 2000.0}

# The JAX CLI's --model choices.
MODEL_NAMES = ("mnist_mlp", "mnist_cnn", "cifar10_cnn", "resnet20",
               "wideresnet40_4")

# Input-shape families for fail-fast model/dataset validation (a wrong
# pairing otherwise surfaces as a reshape error deep inside the round).
MODEL_FAMILY = {"mnist_mlp": "mnist", "mnist_cnn": "mnist",
                "cifar10_cnn": "cifar", "resnet20": "cifar",
                "wideresnet40_4": "cifar"}
DATASET_FAMILY = {MNIST: "mnist", SYNTH_MNIST: "mnist",
                  SYNTH_MNIST_HARD: "mnist", CIFAR10: "cifar",
                  SYNTH_CIFAR10: "cifar", SYNTH_CIFAR10_HARD: "cifar",
                  CIFAR100: "cifar"}


def default_model_for(dataset: str) -> str:
    return {
        MNIST: "mnist_mlp", SYNTH_MNIST: "mnist_mlp",
        CIFAR10: "cifar10_cnn", SYNTH_CIFAR10: "cifar10_cnn",
        SYNTH_CIFAR10_HARD: "cifar10_cnn",
        CIFAR100: "wideresnet40_4",
    }.get(dataset, "mnist_mlp")

# The JAX CLI's -d choices, in its order: the reference's four, Median,
# and the beyond-reference five (DnC, GeoMedian, CenteredClip, FLTrust,
# NormBound), which are not mask-aware (core/faults.py).
DEFENSE_NAMES = ("NoDefense", "Bulyan", "TrimmedMean", "Krum", "FLTrust",
                 "Median", "GeoMedian", "NormBound", "DnC", "CenteredClip")


@dataclasses.dataclass
class FaultConfig:
    """Deterministic client-side fault model (core/faults.py), the JAX
    package's ``FaultConfig`` field for field.

    Every rate is a per-client, per-round probability drawn from a PRNG
    keyed on ``(seed, round)``: the schedule is a pure function of the
    config, and the port draws the JAX package's exact bits
    (utils/threefry.py), so a port run and a JAX run of one config
    inject the same faults.

    Fault kinds (applied to the SUBMITTED update matrix, after the
    attack seam; the attack owns rows [0, f) and corruption is
    restricted to honest rows):

    - ``dropout``: the client returns no update this round.  Its row is
      zeroed and excluded from aggregation via the quarantine mask.
    - ``straggler``: the client submits the gradient it computed
      ``straggler_delay`` rounds ago (a (delay, n, d) ring buffer on the
      device).  Stale updates are aggregated, not quarantined.
    - ``corrupt``: an honest client's row is damaged in flight:
      ``'nan'``/``'inf'`` make it non-finite (quarantined before
      aggregation), ``'scale'`` multiplies it by ``corrupt_scale``
      (finite garbage for the robust aggregation, or failing that the
      divergence watchdog, to absorb).
    - ``shard_dropout``: correlated shard-domain death, for hierarchical
      aggregation only: a dead domain loses its whole megabatch for
      ``shard_dropout_dwell`` rounds; flat and async rounds reject it.

    The watchdog fields govern server-side graceful degradation
    (core/engine.py): at each evaluation round a non-finite or
    norm-exploded server state is rolled back to the last good snapshot
    instead of aborting, at most ``max_rollbacks`` times.
    """

    dropout: float = 0.0
    straggler: float = 0.0
    corrupt: float = 0.0
    shard_dropout: float = 0.0   # correlated shard-domain death rate
    shard_dropout_dwell: int = 1  # rounds a dead domain stays dead
    straggler_delay: int = 1     # rounds of staleness (ring-buffer depth)
    corrupt_mode: str = "nan"    # 'nan' | 'inf' | 'scale'
    corrupt_scale: float = 1e30  # multiplier for corrupt_mode='scale'
    watchdog: bool = True        # divergence watchdog + rollback
    watchdog_norm: float = 1e8   # ||weights|| explosion threshold
    max_rollbacks: int = 3       # rollback attempts before aborting
    seed: Optional[int] = None   # None -> derived from the experiment seed

    def __post_init__(self):
        for name in ("dropout", "straggler", "corrupt", "shard_dropout"):
            v = getattr(self, name)
            if not (0.0 <= v < 1.0):
                raise ValueError(
                    f"fault {name} rate must be in [0, 1), got {v}")
        if self.shard_dropout_dwell < 1:
            raise ValueError(
                f"shard_dropout_dwell must be >= 1, got "
                f"{self.shard_dropout_dwell}")
        if self.straggler_delay < 1:
            raise ValueError(
                f"straggler_delay must be >= 1, got {self.straggler_delay}")
        if self.corrupt_mode not in ("nan", "inf", "scale"):
            raise ValueError(
                f"corrupt_mode must be 'nan', 'inf' or 'scale', "
                f"got {self.corrupt_mode!r}")
        if self.watchdog_norm <= 0:
            raise ValueError(
                f"watchdog_norm must be > 0, got {self.watchdog_norm}")
        if self.max_rollbacks < 0:
            raise ValueError(
                f"max_rollbacks must be >= 0, got {self.max_rollbacks}")

    @property
    def enabled(self) -> bool:
        return (self.dropout > 0 or self.straggler > 0
                or self.corrupt > 0 or self.shard_dropout > 0)


@dataclasses.dataclass
class TrafficConfig:
    """Population & traffic model (core/population.py), the JAX package's
    ``TrafficConfig`` field for field, defaults, checks and messages.

    ``population`` > 0 turns the subsystem on: each round's cohort is
    sampled from a registry of P clients whose per-client persistent
    state (data-shard archetype, femnist-style transform, reliability,
    churn dwell, latency profile) is derived lazily from counter-based
    PRNG streams — never materialized as a (P,)-sized array.  The
    arrival process is a diurnal-modulated base rate with per-client
    blockwise on/off churn (correlated dropout episodes of ~churn_dwell
    rounds) and heavy-tail (Pareto ``latency_tail``) straggler
    latencies feeding the async delivery ring.  The schedule is a pure
    function of ``(TrafficConfig, seed, round)``: replayable on the host
    (population.replay_traffic), resume-exact with no carried state.

    The sybil burst window makes participation an attack axis: with
    ``sybil_burst_period`` > 0 colluders arrive only in the first
    ``sybil_burst_width`` rounds of each period, boosted by
    period/width so the AVERAGE arrived-colluder mass matches the
    uniform profile (fixed average f).

    Robustness half: when churn under-fills a round, the
    defense-validity watchdog degrades through a declared ladder —
    re-mask the configured defense to the arrived sub-cohort while its
    bound holds (Krum m_eff >= 2f+3, Bulyan >= 4f+3), else run
    ``fallback_defense``, else hold the round as a no-op — each
    decision a versioned 'traffic' event (schema v11), never a crash
    or a silent invalid aggregate.
    """

    population: int = 0          # P registered clients; 0 = disabled
    rate: float = 0.9            # base per-round arrival probability scale
    diurnal_amp: float = 0.0     # rate modulation amplitude in [0, 1]
    diurnal_period: int = 24     # rounds per diurnal cycle
    reliability_lo: float = 0.6  # per-client reliability spread
    reliability_hi: float = 0.95
    churn_dwell: int = 4         # mean on/off episode length (rounds)
    latency_scale: float = 1.0   # async delay scale (rounds)
    latency_tail: float = 1.5    # Pareto tail index (smaller = heavier)
    sybil_burst_period: int = 0  # 0 = colluders arrive like honest clients
    sybil_burst_width: int = 1   # rounds of each period colluders arrive in
    fallback_defense: str = "Median"  # ladder step 2 kernel
    min_cohort: int = 1          # hold below this many arrivals regardless
    seed: Optional[int] = None   # None -> derived from the experiment seed

    def __post_init__(self):
        if self.population < 0:
            raise ValueError(
                f"traffic population must be >= 0, got {self.population}")
        if self.rate <= 0:
            raise ValueError(f"traffic rate must be > 0, got {self.rate}")
        if not (0.0 <= self.diurnal_amp <= 1.0):
            raise ValueError(
                f"diurnal_amp must be in [0, 1], got {self.diurnal_amp}")
        if self.diurnal_period < 1:
            raise ValueError(
                f"diurnal_period must be >= 1, got {self.diurnal_period}")
        if not (0.0 < self.reliability_lo <= self.reliability_hi <= 1.0):
            raise ValueError(
                f"need 0 < reliability_lo <= reliability_hi <= 1, got "
                f"{self.reliability_lo}/{self.reliability_hi}")
        if self.churn_dwell < 1:
            raise ValueError(
                f"churn_dwell must be >= 1, got {self.churn_dwell}")
        if self.latency_scale <= 0 or self.latency_tail <= 0:
            raise ValueError(
                f"latency_scale and latency_tail must be > 0, got "
                f"{self.latency_scale}/{self.latency_tail}")
        if self.sybil_burst_period < 0:
            raise ValueError(
                f"sybil_burst_period must be >= 0, got "
                f"{self.sybil_burst_period}")
        if self.sybil_burst_period > 0 and not (
                1 <= self.sybil_burst_width <= self.sybil_burst_period):
            raise ValueError(
                f"sybil_burst_width must be in [1, period="
                f"{self.sybil_burst_period}], got {self.sybil_burst_width}")
        if self.fallback_defense not in ("Median", "TrimmedMean",
                                         "NoDefense"):
            raise ValueError(
                f"fallback_defense must be 'Median', 'TrimmedMean' or "
                f"'NoDefense' (the bounds-valid ladder kernels), got "
                f"{self.fallback_defense!r}")
        if self.min_cohort < 1:
            raise ValueError(
                f"min_cohort must be >= 1, got {self.min_cohort}")

    @property
    def enabled(self) -> bool:
        return self.population > 0


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
    # Local SGD steps per client per round (beyond-reference: the
    # reference is strictly FedSGD — its client optimizer never steps,
    # user.py:80).  k > 1 clients run k local steps at the faded lr and
    # report (w0 - w_k) divided by the lr the SERVER will multiply back
    # in, so the FedAvg-as-FedSGD reduction is exact
    # (core/client.py:make_client_update_fn).
    local_steps: int = 1

    # --- attack ---------------------------------------------------------
    # ALIE z (reference main.py:109); 'auto' resolves at construction
    # to the ALIE paper's z_max (attacks/alie.py:paper_z).
    num_std: "float | str" = 1.5
    backdoor: object = False         # False | 'pattern' | int sample index
    alpha: float = 4.0               # anchor-loss weight, reference main.py:142
    mal_epochs: int = 5              # shadow-net epochs, reference main.py:139
    mal_batch_size: int = 200        # reference backdoor.py:14
    mal_learning_rate: float = 0.1   # shadow SGD lr, reference backdoor.py:132
    mal_weight_decay: float = 1e-4   # reference backdoor.py:132
    # (the reference's shadow-SGD momentum is inert — fresh optimizer per
    # batch, backdoor.py:132 — so it is not a knob here)
    # The JAX package fuses the shadow-train + clip pipeline into its
    # round program; False there is its staged per-round path, which it
    # refuses together with its Pallas defense suite.  The port's
    # defenses always take the kernel route, so only True is accepted;
    # the port's craft seam checks the crafted vector every round
    # (attacks/backdoor.py).
    backdoor_fused: bool = True
    # Perturbation direction for the min-max/min-sum attacks
    # (attacks/minmax.py): cohort negative std ('std', the NDSS'21 paper's
    # best performer), -sign(mean) ('sign'), or negative unit mean ('unit').
    attack_direction: str = "std"
    # DnC spectral defense constants (defenses/dnc.py).  Sketch keys
    # derive from (seed, round, iter), so repeat runs with different
    # seeds draw different coordinate subsets (the paper's
    # random-subsampling assumption).
    dnc_iters: int = 5
    dnc_sketch_dim: int = 2048
    dnc_filter_frac: float = 1.5
    # GeoMedian smoothed-Weiszfeld constants (defenses/geomed.py).
    geomed_iters: int = 10
    geomed_eps: float = 1e-6
    # CenteredClip constants (defenses/centeredclip.py, ICML'21): clip
    # radius and fixed re-centering trips.
    cclip_tau: float = 10.0
    cclip_iters: int = 5

    # --- defense --------------------------------------------------------
    defense: str = "NoDefense"       # reference main.py:112
    # Krum scores sum the n-f smallest distances (reference
    # defences.py:26) unless this selects the paper's n-f-2.
    krum_paper_scoring: bool = False
    # The JAX package's Krum score evaluation of its XLA suite ('sort',
    # 'topk' or 'auto').  The port runs its Pallas suite, where unmasked
    # Krum scores through the fused kernel and masked Krum and Bulyan by
    # sort, so only 'sort' is accepted; the field lets JAX configs load.
    krum_scoring_method: str = "sort"
    # Distance computation dtype: 'bfloat16' casts the (n, d) operand for
    # the Krum/Bulyan distances only (the kernels' bf16 route: a bf16
    # Gram accumulated in f32, f32 norms); training numerics are
    # untouched.  A flagged deviation; 'float32' is reference parity.
    distance_dtype: str = "float32"
    # Bulyan selection batching: q > 1 selects the q lowest-scoring
    # clients per trip against the same scores (ceil(set_size/q) trips),
    # a flagged relaxation of the reference's sequential selection.
    bulyan_batch_select: int = 1
    # Server momentum step on the faded lr instead of the reference's
    # constant base lr (server.py:89; the faded lr reaches only the
    # clients and the attacker there).
    server_uses_faded_lr: bool = False

    # --- topology of the round ----------------------------------------
    # 'flat' (the default) is the reference path: one (n, d) gradient
    # matrix, one defense call.  'async' is the FedBuff-style buffered
    # round (core/async_rounds.py): every client computes a fresh update
    # each round, but it ARRIVES a PRNG-drawn number of rounds later; the
    # server consumes the first `async_buffer` pending arrivals per round
    # FIFO, weighting each delivered row by its staleness through the
    # mask-aware kernels' `weights=` seam.  'hierarchical' streams the
    # client axis through megabatches of static size `megabatch` (m << n):
    # per-megabatch tier-1 robust estimates (the same mask-aware kernels,
    # `defense`), then a tier-2 robust reduction over the (n/m, d)
    # estimate matrix (defenses/kernels.py shard_* entries); the full
    # (n, d) matrix never exists (ops/federated.py).
    aggregation: str = "flat"        # 'flat' | 'hierarchical' | 'async'
    # Megabatch (tier-1 shard) size m; must divide users_count with at
    # least 2 shards.  Peak round memory scales with m*d, not n*d.
    megabatch: int = 0
    # Tier-2 reducer over shard estimates; None = same family as
    # `defense`.  Restricted to the mask-aware kernel set.
    tier2_defense: Optional[str] = None
    # Colluder placement across megabatches: 'spread' deals the malicious
    # ids [0, f) round-robin over shards, 'concentrated' packs them into
    # the fewest shards.
    mal_placement: str = "spread"
    # Assumed corrupted bounds per tier; None derives the spread worst
    # case defaults ceil(f/S) and ceil(f/m) (ops/federated.py
    # tier1_assumed/tier2_assumed).
    tier1_corrupted: Optional[int] = None
    tier2_corrupted: Optional[int] = None
    # k: pending updates aggregated per round (FIFO; required >= 1
    # under aggregation='async').  The three async knobs are inert
    # unless aggregation='async'.
    async_buffer: int = 0
    # Eviction bound: a pending update older than this many rounds is
    # discarded (masked), never aggregated; arrival delays draw
    # uniformly from [0, max_staleness] (ring depth = max_staleness+1).
    async_max_staleness: int = 2
    # Contribution discount by staleness s (core/async_rounds.py):
    # 'none' = 1 (pure first-k), 'poly' = 1/sqrt(1+s) (the FedBuff
    # paper's discount), 'const' = 0.5 for any stale row.
    staleness_weight: str = "none"

    # --- evaluation, logging and checkpoints ----------------------------
    test_step: int = 5               # reference main.py:58
    checkpoint_acc_threshold: float = 70.0  # reference main.py:84
    output: Optional[str] = None     # tee file, reference main.py:13-18
    log_dir: str = "logs"
    run_dir: str = "runs"
    data_dir: str = "data"           # raw MNIST idx location

    # --- determinism and data -------------------------------------------
    seed: int = 0
    synth_train: int = 10000
    synth_test: int = 2000
    # 'iid' (DistributedSampler-equivalent, reference user.py:49-54) |
    # 'dirichlet' (label skew) | 'femnist_style' (per-client affine
    # input transform over IID shards; data/partition.py
    # client_style_params).
    partition: str = "iid"
    dirichlet_alpha: float = 0.5
    style_strength: float = 0.25     # 'femnist_style' contrast/brightness
                                     # spread; 0 degenerates to IID

    # --- per-round client participation (beyond-reference) -------------
    # Fraction of clients sampled each round.  Cohort sizes are STATIC —
    # round(p*f) malicious + the honest remainder — with random
    # identities per round (core/engine.py:participants), the JAX
    # package's draw bit for bit.
    participation: float = 1.0
    # Dtype of the (m, d) gradient matrix on the wire: 'bfloat16' halves
    # its bytes at large n (the distance kernels take it as bf16).
    grad_dtype: str = "float32"

    # --- train-time augmentation ---------------------------------------
    # Reference parity: only the CIFAR100 train pipeline augments
    # (reflect-pad 4 + RandomCrop(32) + RandomHorizontalFlip, reference
    # data_sets.py:157-166); None follows that rule, True/False overrides
    # (data/augment.py).
    data_augment: Optional[bool] = None
    # The JAX package's jax.checkpoint of the client loss.  Its torch
    # counterpart, torch.utils.checkpoint, cannot run under the port's
    # vmap(grad(...)) client step, so only False is accepted.
    remat: bool = False

    # --- metadata subsystem (reference C12, vestigial there) ------------
    collect_metadata: bool = False
    metadata_fraction: float = 0.11  # reference user.py:65 test_size=0.11

    # --- faults & recovery (core/faults.py) -----------------------------
    # None (the default) is the zero-fault round.  A FaultConfig (or an
    # equivalent dict, coerced below) with any rate > 0 turns on fault
    # injection, the quarantine mask and the divergence watchdog.
    faults: Optional[FaultConfig] = None
    # --- population & traffic (core/population.py) ----------------------
    # None (the default) is the resident-cohort round.  A TrafficConfig
    # (or an equivalent dict, coerced below) with population > 0 samples
    # each round's cohort from the lazy client registry, injects
    # correlated churn and the defense-validity degradation ladder
    # (flat), and draws async arrival delay from the latency profile
    # (async).
    traffic: Optional[TrafficConfig] = None
    # Rotated auto-checkpoints every N rounds (0 = off,
    # utils/checkpoint.py): the --resume target after a kill and the
    # divergence watchdog's rollback target (core/engine.py).
    checkpoint_every: int = 0

    def __post_init__(self):
        if self.model is not None and self.model in MODEL_FAMILY:
            want = DATASET_FAMILY.get(self.dataset)
            if want is not None and MODEL_FAMILY[self.model] != want:
                raise ValueError(
                    f"model {self.model!r} expects {MODEL_FAMILY[self.model]}"
                    f"-shaped inputs but dataset {self.dataset!r} is "
                    f"{want}-shaped")
        if self.dataset not in DATASETS:
            raise ValueError(f"Unknown dataset {self.dataset!r}")
        if self.remat:
            raise ValueError(
                "remat=True is not available in the port: "
                "torch.utils.checkpoint registers saved-tensor hooks, and "
                "torch.func.{grad, vjp, jacrev, hessian} don't yet support "
                "saved tensor hooks, so it cannot run under the client "
                "step's vmap(grad(...)); drop remat")
        if self.defense not in DEFENSE_NAMES:
            raise ValueError(
                f"defense must be one of {DEFENSE_NAMES}, "
                f"got {self.defense!r}")
        if self.partition not in ("iid", "dirichlet", "femnist_style"):
            raise ValueError(f"Unknown partition {self.partition!r}")
        if self.krum_scoring_method not in ("sort", "topk", "auto"):
            raise ValueError(
                f"krum_scoring_method must be 'sort', 'topk' or 'auto', "
                f"got {self.krum_scoring_method!r}")
        if self.krum_scoring_method != "sort":
            raise ValueError(
                f"krum_scoring_method={self.krum_scoring_method!r} is not "
                f"ported: the port runs the Pallas defense suite, where "
                f"unmasked Krum scores through the fused kernel and masked "
                f"Krum and Bulyan by sort, so the method would have no "
                f"effect; drop --krum-scoring-method")
        if self.distance_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"distance_dtype must be 'float32' or 'bfloat16', "
                f"got {self.distance_dtype!r}")
        if self.grad_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"grad_dtype must be 'float32' or 'bfloat16', "
                f"got {self.grad_dtype!r}")
        if self.aggregation not in ("flat", "hierarchical", "async"):
            raise ValueError(
                f"aggregation must be 'flat', 'hierarchical' or "
                f"'async', got {self.aggregation!r}")
        if self.staleness_weight not in ("none", "poly", "const"):
            raise ValueError(
                f"staleness_weight must be 'none', 'poly' or 'const', "
                f"got {self.staleness_weight!r}")
        if self.async_buffer < 0 or self.async_max_staleness < 0:
            raise ValueError(
                f"async_buffer/async_max_staleness must be >= 0, got "
                f"{self.async_buffer}/{self.async_max_staleness}")
        if self.aggregation == "async" and self.async_buffer < 1:
            raise ValueError(
                "--aggregation async needs --async-buffer >= 1 (k, the "
                "pending updates aggregated per round — FedBuff's "
                "buffer size; core/async_rounds.py)")
        if self.mal_placement not in ("spread", "concentrated"):
            raise ValueError(
                f"mal_placement must be 'spread' or 'concentrated', "
                f"got {self.mal_placement!r}")
        if self.megabatch < 0:
            raise ValueError(f"megabatch must be >= 0, got {self.megabatch}")
        _TIER2 = ("NoDefense", "Krum", "TrimmedMean", "Bulyan", "Median")
        if self.tier2_defense is not None and self.tier2_defense not in _TIER2:
            raise ValueError(
                f"tier2_defense must be one of {_TIER2}, "
                f"got {self.tier2_defense!r}")
        for name in ("tier1_corrupted", "tier2_corrupted"):
            v = getattr(self, name)
            if v is not None and v < 0:
                raise ValueError(f"{name} must be >= 0, got {v}")
        if self.aggregation == "hierarchical":
            if self.megabatch < 1:
                raise ValueError(
                    "hierarchical aggregation needs megabatch >= 1 "
                    "(the tier-1 shard size; --megabatch)")
            if self.users_count % self.megabatch:
                raise ValueError(
                    f"megabatch must divide users_count "
                    f"({self.users_count} % {self.megabatch} != 0)")
            if self.users_count // self.megabatch < 2:
                raise ValueError(
                    f"hierarchical aggregation needs >= 2 shards "
                    f"(n={self.users_count}, m={self.megabatch})")
        if self.bulyan_batch_select < 1:
            raise ValueError(
                f"bulyan_batch_select must be >= 1, got "
                f"{self.bulyan_batch_select}")
        if self.local_steps < 1:
            raise ValueError(
                f"local_steps must be >= 1, got {self.local_steps}")
        if not (0.0 < self.participation <= 1.0):
            raise ValueError(
                f"participation must be in (0, 1], got "
                f"{self.participation}")
        if self.backdoor and not self.backdoor_fused:
            raise ValueError(
                "--backdoor-staged aggregates eagerly on the host "
                "between compute and craft; the Pallas defense "
                "suite is a device-kernel route (and the "
                "staged==fused bit-identity pin needs both modes "
                "on one kernel) — drop --backdoor-staged")
        if self.attack_direction not in ("std", "sign", "unit"):
            raise ValueError(
                f"attack_direction must be 'std', 'sign' or 'unit', "
                f"got {self.attack_direction!r}")
        if self.dnc_iters < 1 or self.dnc_sketch_dim < 1:
            raise ValueError(
                f"dnc_iters/dnc_sketch_dim must be >= 1, got "
                f"{self.dnc_iters}/{self.dnc_sketch_dim}")
        if self.dnc_filter_frac <= 0:
            raise ValueError(
                f"dnc_filter_frac must be > 0, got {self.dnc_filter_frac}")
        if self.cclip_iters < 1 or self.cclip_tau <= 0:
            raise ValueError(
                f"cclip_iters must be >= 1 and cclip_tau > 0, got "
                f"{self.cclip_iters}/{self.cclip_tau}")
        if self.geomed_iters < 1 or self.geomed_eps <= 0:
            raise ValueError(
                f"geomed_iters must be >= 1 and geomed_eps > 0, got "
                f"{self.geomed_iters}/{self.geomed_eps}")
        if isinstance(self.faults, dict):
            self.faults = FaultConfig(**self.faults)
        if isinstance(self.traffic, dict):
            self.traffic = TrafficConfig(**self.traffic)
        if self.checkpoint_every < 0:
            raise ValueError(
                f"checkpoint_every must be >= 0, got "
                f"{self.checkpoint_every}")
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
            self.model = default_model_for(self.dataset)
        if self.backdoor == "No":
            self.backdoor = False  # reference main.py:135-136
        elif isinstance(self.backdoor, str) and self.backdoor.isdigit():
            # reference main.py:116 leaves '1'|'2'|'3' as strings, which
            # crashes at backdoor.py:34 (str - int); we coerce instead.
            self.backdoor = int(self.backdoor)

    @property
    def corrupted_count(self) -> int:
        # reference main.py:21 / server.py:87
        return int(self.mal_prop * self.users_count)

    def csv_name(self) -> str:
        # Filename schema of reference main.py:100.
        return ("{}_stdev_{}_{}_backdoor-{}_mal_prop_{}_users_{}_alpha_{}_lr_{}"
                ".csv").format(self.dataset, self.num_std, self.defense,
                               self.backdoor, self.mal_prop, self.users_count,
                               self.alpha, self.learning_rate)
