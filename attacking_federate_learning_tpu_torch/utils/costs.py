"""Stage scopes, the counted cost of an entry point, and the wire ledger.

The port's copy of the JAX package's utils/costs.py, in PyTorch terms.

- **Stages.** :data:`STAGES` is the round's taxonomy, in round order
  (``deliver -> quarantine -> protect -> tier1_aggregate ->
  tier2_aggregate -> apply``).  The engines open :func:`stage_scope` at
  the JAX package's sites.  A scope is a
  ``torch.profiler.record_function(name)`` range while a profiler capture
  is open (:func:`capturing`, utils/profiling.py:device_trace), so the
  stage rides the trace itself (utils/walls.py books a capture by it),
  and it pushes the stage on a small Python stack that the cost counter
  reads.  A scope launches nothing; and unless a capture or a count has
  armed the scopes (:func:`armed`), it is a shared no-op
  context: with every observability flag off a round makes the same
  torch calls as without the scopes.  :func:`in_stage` puts a whole
  function (a defense, an engine method) in a stage.  The JAX package's
  ``FL_STAGE_SCOPES`` switch, which keeps its HLO metadata and compile
  cache keys stable, has no counterpart: the port has no HLO, and its
  scopes cost nothing unless armed.

- **Counted cost.**  XLA's ``cost_analysis`` has no PyTorch counterpart,
  so :func:`count_costs` counts: a ``TorchDispatchMode`` books each aten
  operation's FLOPs (PyTorch's own formulas for matmuls and
  convolutions, one a pointwise output element, one a reduced input
  element, n log2 n a sort) and its bytes (every tensor argument read
  once, every output written once; views and empty allocations move
  nothing) to the innermost open stage.  Stage sums plus
  ``unattributed`` equal the totals by construction.  A hand-written
  kernel is launched through ``ctypes`` and is invisible to dispatch:
  its wrapper is decorated with :func:`counted_kernel`, which books the
  kernel's modeled count (the formula beside the wrapper in ``ops/``,
  the one the kernel table's bound uses) and silences the count of
  whatever the wrapper runs inside (on the CPU, its plain version).  An
  entry point's count is therefore the same work on the CPU and on the
  card.  (Under a capture the kernel's launch itself is a range named by
  its C entry point: ops/_build.py:entry_point.)  :class:`CompileLedger`
  collects one :class:`CostRecord` an entry point
  (core/engine.py:cost_report), and the kernel libraries' build facts
  (ops/_build.py) as 'compile' records.

- **Wire ledger.**  :data:`WIRE_SEAMS` and :func:`wire_ledger` are the
  JAX package's, unchanged: the bytes each protocol seam moves a round,
  from the topology alone.

Not ported, since they read XLA's HLO, which the port has none of:
``canonical_hlo``, ``hlo_fingerprint``, ``collective_hlo_bytes``,
``stage_attribution`` over HLO text, the persistent-cache counters and
``compilation_cache_dir``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Callable, NamedTuple, Optional, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# The round's stages, in round order.  ``deliver`` covers the batch
# gather, the client update and the attack's craft (and the async
# delivery ring); ``quarantine`` the fault injection and screen and the
# async re-mask; ``protect`` secure aggregation's masks; the aggregate
# stages the tier-1 defense and the tier-2 shard reduction; ``apply`` the
# server's momentum step.
STAGES = ("deliver", "quarantine", "protect",
          "tier1_aggregate", "tier2_aggregate", "apply")
_STAGE_SET = frozenset(STAGES)

# Captures, timers and counts open now (they arm the scopes), profiler
# captures open now (they give a scope its record_function range), the
# open stages (innermost last) and the open cost counter.
_ARMED = 0
_CAPTURES = 0
_STACK: list = []
_COUNTER: Optional["CostCounter"] = None
_NULL = contextlib.nullcontext()


@contextlib.contextmanager
def armed():
    """Arm the stage scopes for the block (a count)."""
    global _ARMED
    _ARMED += 1
    try:
        yield
    finally:
        _ARMED -= 1


@contextlib.contextmanager
def capturing():
    """Arm the stage scopes for a profiler capture: each scope (and each
    hand kernel's launch, ops/_build.py:entry_point) opens a
    ``record_function`` range."""
    global _ARMED, _CAPTURES
    _ARMED += 1
    _CAPTURES += 1
    try:
        yield
    finally:
        _CAPTURES -= 1
        _ARMED -= 1


class _StageScope:
    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self):
        _STACK.append(self.name)
        if _CAPTURES:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        _STACK.pop()
        return False


def stage_scope(name: str):
    """The context of stage ``name``: a ``record_function`` range under a
    capture and an entry on the stage stack while armed, else a shared
    no-op context."""
    assert name in _STAGE_SET, f"unknown stage {name!r} (taxonomy: {STAGES})"
    if not _ARMED:
        return _NULL
    return _StageScope(name)


def in_stage(stage: str):
    """Decorate ``fn`` so that every call runs in ``stage``'s scope,
    whatever call site made it (the defense dispatch: the round, a
    hierarchical megabatch, the cost report's ``defense_<name>`` and
    ``tier2_<name>`` entries; the engine's methods).
    Attribute-transparent: ``needs_round`` / ``needs_server_grad`` ride
    ``functools.wraps``'s ``__dict__`` copy, and a partial's ``func`` /
    ``args`` / ``keywords`` are copied over."""
    assert stage in _STAGE_SET, f"unknown stage {stage!r} (taxonomy: {STAGES})"

    def deco(fn):
        @functools.wraps(fn)
        def scoped(*args, **kwargs):
            with stage_scope(stage):
                return fn(*args, **kwargs)

        for attr in ("func", "args", "keywords"):
            if hasattr(fn, attr) and not hasattr(scoped, attr):
                setattr(scoped, attr, getattr(fn, attr))
        return scoped
    return deco


def current_stage() -> Optional[str]:
    """The innermost open stage, or None."""
    return _STACK[-1] if _STACK else None


# --- counted cost --------------------------------------------------------

class KernelCost(NamedTuple):
    """A hand kernel's modeled work for one call: ``flops`` operations of
    ``unit`` ('fp32', 'bf16' on the tensor cores, or 'int32') and
    ``bytes`` moved (each input read once, each output written once)."""

    flops: float
    bytes: float
    unit: str = "fp32"


# Aten operations that allocate without writing, or only read metadata.
_NO_DATA = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                      "new_empty_strided", "lift_fresh", "detach",
                      "_local_scalar_dense", "sym_size", "sym_stride",
                      "sym_numel", "sym_storage_offset", "is_same_size"})
_SORTS = frozenset({"sort", "argsort", "msort", "topk", "kthvalue",
                    "median", "nanmedian"})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def op_cost(func, args, kwargs, out):
    """(FLOPs, bytes) of one aten operation, the counter's model."""
    if func.namespace != "aten":
        return 0.0, 0.0
    packet = func._overloadpacket
    name = packet.__name__
    returns = func._schema.returns
    if name in _NO_DATA or (returns and returns[0].alias_info is not None
                            and not returns[0].alias_info.is_write):
        return 0.0, 0.0                    # a view, or no data moved
    ins = [t for t in tree_leaves((args, kwargs))
           if isinstance(t, torch.Tensor)]
    outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    nbytes = float(sum(_nbytes(t) for t in ins) + sum(_nbytes(t)
                                                      for t in outs))
    from torch.utils.flop_counter import flop_registry

    if packet in flop_registry:
        flops = float(flop_registry[packet](*args, **(kwargs or {}),
                                            out_val=out))
    elif torch.Tag.pointwise in func.tags:
        flops = float(sum(t.numel() for t in outs))
    elif torch.Tag.reduction in func.tags:
        flops = float(max((t.numel() for t in ins), default=0))
    elif name in _SORTS and ins:
        n = ins[0].numel()
        flops = n * max(1.0, math.log2(max(n, 2)))
    else:
        flops = 0.0                        # data movement
    return flops, nbytes


class CostCounter(TorchDispatchMode):
    """Books each aten operation's (FLOPs, bytes) to the innermost open
    stage, and the hand kernels' modeled counts (:func:`counted_kernel`)
    to theirs; ``kernels`` keeps the latter by kernel name."""

    def __init__(self):
        super().__init__()
        self.stages = {s: {"flops": 0.0, "bytes_accessed": 0.0}
                       for s in STAGES}
        self.unattributed = {"flops": 0.0, "bytes_accessed": 0.0}
        self.kernels: dict = {}
        self._quiet = 0

    def book(self, flops: float, nbytes: float) -> None:
        bucket = (self.stages[_STACK[-1]] if _STACK
                  else self.unattributed)
        bucket["flops"] += flops
        bucket["bytes_accessed"] += nbytes

    def book_kernel(self, name: str, cost: KernelCost) -> None:
        self.book(cost.flops, cost.bytes)
        row = self.kernels.setdefault(
            name, {"calls": 0, "flops": 0.0, "bytes_accessed": 0.0,
                   "unit": cost.unit, "stages": {}})
        row["calls"] += 1
        row["flops"] += cost.flops
        row["bytes_accessed"] += cost.bytes
        stage = current_stage() or "unattributed"
        row["stages"][stage] = row["stages"].get(stage, 0) + 1

    @contextlib.contextmanager
    def quiet(self):
        """Count nothing of what runs in the block."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._quiet:
            flops, nbytes = op_cost(func, args, kwargs, out)
            if flops or nbytes:
                self.book(flops, nbytes)
        return out

    def totals(self) -> dict:
        return {m: math.fsum([self.unattributed[m]]
                             + [self.stages[s][m] for s in STAGES])
                for m in ("flops", "bytes_accessed")}

    def attribution(self) -> dict:
        """The stage partition in ``stage_attribution``'s layout:
        ``stages`` (the stages that counted anything), ``unattributed``
        and ``coverage`` (the named share of each metric)."""
        tot = self.totals()
        named = {m: math.fsum(self.stages[s][m] for s in STAGES)
                 for m in tot}
        return {
            "stages": {s: dict(v) for s, v in self.stages.items()
                       if v["flops"] or v["bytes_accessed"]},
            "unattributed": dict(self.unattributed),
            "coverage": {m: (named[m] / tot[m] if tot[m] else 0.0)
                         for m in tot},
        }


@contextlib.contextmanager
def count_costs():
    """Count every operation of the block (:class:`CostCounter`), with
    the stage scopes armed; yields the counter."""
    global _COUNTER
    counter = CostCounter()
    prev, _COUNTER = _COUNTER, counter
    try:
        with armed(), counter:
            yield counter
    finally:
        _COUNTER = prev


def counted_kernel(name: Union[str, Callable[..., str]],
                   cost: Callable[..., KernelCost]):
    """Decorate a hand kernel's wrapper.  Under :func:`count_costs` a
    call books ``cost(*args, **kwargs)`` (the kernel's modeled work)
    under the kernel's name (``name``, or ``name(*args, **kwargs)`` for a
    route that depends on the arguments) and counts nothing of what the
    wrapper runs.  Otherwise the wrapper runs as it is."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            counter = _COUNTER
            if counter is None or counter._quiet:
                return fn(*args, **kwargs)
            with counter.quiet():     # the formula's own reads too
                kname = (name if isinstance(name, str)
                         else name(*args, **kwargs))
                counter.book_kernel(kname, cost(*args, **kwargs))
                return fn(*args, **kwargs)
        return wrapper
    return deco


def capturing_now() -> bool:
    """Whether a profiler capture is open (:func:`capturing`)."""
    return _CAPTURES > 0


# --- per-seam wire ledger (the JAX package's, unchanged) ------------------

# Every protocol seam a round can cross, in round order.  Absent seams
# (e.g. tier1_to_tier2 on a flat topology) are omitted, zero-byte seams
# (secagg on, nobody dropped) are kept — the column exists, it is empty.
WIRE_SEAMS = ("broadcast", "client_update", "tier1_to_tier2",
              "secagg_mask_exchange", "secagg_recovery",
              "async_delivery")


def wire_ledger(*, cohort: int, dim: int, grad_bytes: int = 4,
                topology: str = "flat", num_shards: Optional[int] = None,
                megabatch: Optional[int] = None, spmd_parts: int = 1,
                secagg: str = "off", key_bytes: int = 32,
                dropped: int = 0,
                async_buffer: Optional[int] = None,
                model_parts: int = 1,
                gram_rows: int = 0) -> dict:
    """Bytes-per-round on every protocol seam, priced from the topology
    parameters alone (f32 model wire; ``grad_bytes`` prices a quantized
    client→server leg).

    Seams: server→client ``broadcast`` (every cohort member pulls the
    d-dim f32 model), ``client_update`` (cohort·d·grad_bytes up),
    hierarchical ``tier1_to_tier2`` (S estimates to the tier-2 reducer
    — exactly the ``S·d·4`` an SPMD all_gather moves per device),
    secagg ``mask_exchange``
    (one pairwise key/masked-seed exchange per client pair — vanilla
    C(n,2), groupwise S·C(m,2)) + ``recovery`` (each dropout makes
    every survivor reveal one pairwise secret), and the ``async
    delivery`` ring (buffer-capacity updates of d·grad_bytes per round,
    the capacity bound on what one round can deliver).

    The port's model axis (``model_parts`` m > 1 positions splitting d)
    adds two seams the JAX package's ledger leaves to XLA:
    ``model_partials``, the block Grams every position sends to the
    primary for Krum's and Bulyan's distances, m (n, n) f32 Grams of
    4 * ``gram_rows``**2 bytes (n the cohort; 0 for the other defenses),
    and ``model_state``, the d * 4 bytes of the weights' column blocks
    gathered for deliver once a round."""
    seams: dict = {}
    seams["broadcast"] = {"bytes": cohort * dim * 4}
    seams["client_update"] = {"bytes": cohort * dim * grad_bytes}
    if topology == "hierarchical" and num_shards:
        seams["tier1_to_tier2"] = {
            "bytes": num_shards * dim * 4,
            "collective": spmd_parts > 1,
        }
    if secagg != "off":
        if secagg == "groupwise" and num_shards and megabatch:
            pairs = num_shards * (megabatch * (megabatch - 1) // 2)
        else:
            pairs = cohort * (cohort - 1) // 2
        seams["secagg_mask_exchange"] = {"bytes": pairs * key_bytes}
        seams["secagg_recovery"] = {
            "bytes": dropped * max(cohort - 1, 0) * key_bytes}
    if topology == "async" and async_buffer:
        seams["async_delivery"] = {
            "bytes": async_buffer * dim * grad_bytes}
    if model_parts > 1:
        seams["model_partials"] = {
            "bytes": model_parts * 4 * gram_rows * gram_rows,
            "collective": True}
        seams["model_state"] = {"bytes": dim * 4, "collective": True}
    return {
        "topology": topology, "cohort": cohort, "dim": dim,
        "grad_bytes": grad_bytes,
        "seams": seams,
        "total_bytes": sum(s["bytes"] for s in seams.values()),
    }


# --- per-entry-point records ------------------------------------------------

@dataclasses.dataclass
class CostRecord:
    """The counted facts of one entry point (or, as a 'compile' record,
    one kernel library's build).

    ``flops`` / ``bytes_accessed`` are :func:`count_costs`' totals (-1:
    not counted); ``peak_allocated`` is the CUDA allocator's peak above
    the entry point's start, None where it was not measured (the CPU);
    ``collective_bytes`` is 0, one device.  ``kernels`` holds each hand
    kernel's calls and modeled count; ``attribution`` the stage
    partition.  ``compile_s`` / ``cache`` are a library's build time and
    whether it was already built ('hit') or nvcc ran ('miss')."""

    name: str
    platform: str
    flops: float = -1.0
    bytes_accessed: float = -1.0
    peak_allocated: Optional[int] = None
    collective_bytes: int = 0
    compile_s: float = 0.0
    cache: str = "uncached"
    attribution: Optional[dict] = None
    kernels: dict = dataclasses.field(default_factory=dict)

    @property
    def peak_bytes(self) -> int:
        """The measured peak, or 0 where it was not measured
        (``peak_measured`` in the event says which)."""
        return int(self.peak_allocated or 0)

    def cost_event(self) -> dict:
        """Payload for a 'cost' event (metrics.py schema v2)."""
        return dict(kind="cost", name=self.name, flops=self.flops,
                    bytes_accessed=self.bytes_accessed,
                    peak_bytes=self.peak_bytes,
                    peak_measured=self.peak_allocated is not None,
                    collective_bytes=self.collective_bytes,
                    kernels=self.kernels)

    def compile_event(self) -> dict:
        """Payload for a 'compile' event (metrics.py schema v2)."""
        return dict(kind="compile", name=self.name,
                    compile_s=round(self.compile_s, 4), cache=self.cache,
                    platform=self.platform)

    def stage_event(self) -> Optional[dict]:
        """Payload for a 'stage_cost' event (metrics.py schema v9), or
        None when nothing was attributed."""
        if self.attribution is None:
            return None
        att = self.attribution
        return dict(kind="stage_cost", name=self.name,
                    stages=att["stages"],
                    unattributed=att["unattributed"],
                    coverage=att["coverage"])


def analyze(name: str, thunk: Callable[[], object],
            device) -> CostRecord:
    """Run ``thunk`` once under :func:`count_costs` and return its
    CostRecord; on a CUDA device the allocator's peak above the start is
    measured around it."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.memory_allocated(dev)
    with count_costs() as counter:
        thunk()
    peak = None
    if cuda:
        torch.cuda.synchronize(dev)
        peak = int(torch.cuda.max_memory_allocated(dev) - start)
    tot = counter.totals()
    return CostRecord(name=name, platform=dev.type, flops=tot["flops"],
                      bytes_accessed=tot["bytes_accessed"],
                      peak_allocated=peak,
                      attribution=counter.attribution(),
                      kernels=counter.kernels)


class CompileLedger:
    """A run's cost records (core/engine.py:cost_report fills one):
    ``records`` one an entry point, ``compiles`` one a kernel library
    built or loaded in this process, ``errors`` (name, message) of entry
    points that failed, ``wire`` the wire ledger."""

    def __init__(self):
        self.records: list = []
        self.compiles: list = []
        self.errors: list = []
        self.wire: Optional[dict] = None

    def analyze(self, name: str, thunk, device) -> CostRecord:
        rec = analyze(name, thunk, device)
        self.records.append(rec)
        return rec

    def add_compiles(self, facts: dict) -> None:
        """Kernel libraries' build facts (ops/_build.py COMPILES) as
        'compile' records."""
        for lib, fact in facts.items():
            self.compiles.append(CostRecord(
                name=lib, platform="cuda", compile_s=fact["compile_s"],
                cache=fact["cache"]))

    def emit(self, logger) -> None:
        """One 'compile' event a library; one 'cost' and one
        'stage_cost' event an entry point; one 'wire_bytes' event."""
        for rec in self.compiles:
            logger.record(**rec.compile_event())
        for rec in self.records:
            logger.record(**rec.cost_event())
            stage = rec.stage_event()
            if stage is not None:
                logger.record(**stage)
        if self.wire is not None:
            logger.record(kind="wire_bytes", **self.wire)
