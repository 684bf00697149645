"""FedBuff-style asynchronous buffered rounds (``aggregation='async'``).

The JAX package's ``core/async_rounds.py`` on the port's devices.  Every
client computes a fresh update every round, but the update ARRIVES ``s``
rounds later, ``s`` drawn per (client, round) from the JAX package's
threefry bits, keyed on ``(seed ^ 0x0A57C, round)``; the whole arrival
schedule is a pure function of the config, so a port run, a JAX run and
the host replay (:func:`replay_schedule`) see the same one.

- In-flight updates ride a fixed-shape ``(D, m, d)`` ring on the device
  (slot ``t % D`` holds round-t arrivals; ``D = async_max_staleness +
  1``) with an occupancy mask and per-entry birth rounds.  A client's
  newer update landing on a slot that still holds an older in-flight one
  SUPERSEDES it.
- Arrivals merge into a one-slot-per-client PENDING pool: an arrival
  supersedes the client's older pending update, while a late, staler
  arrival is discarded.  Pending updates older than
  ``async_max_staleness`` are EVICTED and non-finite ones (corruption in
  flight) QUARANTINED, both masked, never aggregated.
- Once ``k = async_buffer`` updates are pending (FedBuff's trigger) the
  server consumes the k oldest in FIFO order (birth, then client id);
  below the trigger the round delivers nothing and the engine holds its
  state.  A delivered round aggregates exactly k rows.
- Delivered rows carry their STALENESS ``t - birth`` into the attack
  seam (``AttackContext.staleness``) and into the staleness weights
  (:func:`staleness_weights`) that reach the mask-aware defense kernels
  through their ``weights=`` seam.

Faults compose (core/faults.py's schedule, its own key): dropout means
no submission, a straggler's update arrives ``straggler_delay`` rounds
later still (clipped to the ring), and corruption damages an honest row
in flight.  A ``timed`` attacker (attacks/backdoor.py
TimedBackdoorAttack) submits its rows [0, f) with delay 0.

The schedule (delays, drops, corruption) is drawn on the host, as the
fault schedule is; the ring, the pool, the quarantine and the FIFO pick
run on the device as plain tensor ops (they are XLA, not Pallas, in the
JAX package), with no device-to-host read.  The six state tensors keep
the JAX package's names and dtypes, so checkpoints carry them both ways.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from attacking_federate_learning_tpu_torch.config import host_knobs
from attacking_federate_learning_tpu_torch.core.faults import (
    MASK_AWARE_DEFENSES, fault_masks
)
from attacking_federate_learning_tpu_torch.utils import threefry
from attacking_federate_learning_tpu_torch.utils.costs import stage_scope

# Staleness-weight functions w(s) for delivered rows (s >= 0 rounds):
#   'none'   w = 1           (pure FedBuff first-k, no discount)
#   'poly'   w = 1/sqrt(1+s) (the FedBuff paper's polynomial discount)
#   'const'  w = 1 if fresh else 0.5 (a flat stale discount)
STALENESS_WEIGHTS = ("none", "poly", "const")

# FIFO sort key of an empty pending slot: after every real key birth*m +
# id (exact integers, as the JAX package's f32 keys are below 2**24).
_EMPTY_KEY = torch.iinfo(torch.int64).max

# The per-round counts of :func:`async_step`, in the JAX event's order.
COUNT_NAMES = ("delivered", "pending", "in_flight", "evicted",
               "quarantined", "superseded")


@dataclasses.dataclass(frozen=True)
class AsyncSpec:
    """Static facts of one engine's async round (engine _init_async)."""

    buffer: int          # k: pending updates consumed per round (FIFO)
    max_staleness: int   # eviction bound; ring depth = max_staleness+1
    weighting: str       # 'none' | 'poly' | 'const'
    timed: bool = False  # attacker forces its own delay to 0

    @property
    def depth(self) -> int:
        return self.max_staleness + 1


def async_key(cfg) -> np.ndarray:
    """The async subsystem's own key, derived from (but distinct from)
    the experiment seed, as core/faults.py:fault_key is."""
    return threefry.key(cfg.seed ^ 0x0A57C)


def init_async_state(spec: AsyncSpec, m: int, d: int, device) -> dict:
    """The in-flight ring (``buf``/``occ``/``birth``, one slot per
    arrival round) and the pending pool (``pbuf``/``pocc``/``pbirth``,
    one slot per client), zeroed on ``device``: f32, bool and int32, the
    JAX package's layout."""
    D = spec.depth
    return {
        "buf": torch.zeros((D, m, d), dtype=torch.float32, device=device),
        "occ": torch.zeros((D, m), dtype=torch.bool, device=device),
        "birth": torch.zeros((D, m), dtype=torch.int32, device=device),
        "pbuf": torch.zeros((m, d), dtype=torch.float32, device=device),
        "pocc": torch.zeros((m,), dtype=torch.bool, device=device),
        "pbirth": torch.zeros((m,), dtype=torch.int32, device=device),
    }


def draw_delays(key, t: int, m: int, m_mal: int, spec: AsyncSpec,
                faults=None, fkey=None, latency=None):
    """The round-t arrival schedule on the host: ``(delay, drop,
    corrupt)``, (m,) numpy int32, bool, bool.

    ``delay`` is uniform in [0, depth) per (client, round), the JAX
    package's ``randint(fold_in(key, t), (m,), 0, depth)``, plus
    ``straggler_delay`` for straggler-fault rows (clipped to depth - 1),
    and 0 for the attacker's rows under a timed attack.  ``drop`` and
    ``corrupt`` are the fault schedule's masks (all False without
    faults), drawn from ``fkey`` (core/faults.py:fault_key; ``key`` when
    it is None) as the flat round draws them.

    ``latency`` (the traffic engine, core/population.py): an optional
    ``(scales, tail)`` pair, the per-row heavy-tail Pareto scales and the
    shared tail exponent, that replaces the uniform draw with
    :func:`~.population.traffic_delays` (still pure in ``(key, t)``,
    clipped to the ring's depth the same way)."""
    delay, drop, _, corrupt = _schedule(key, t, m, m_mal, spec, faults, fkey,
                                        latency)
    return delay, drop, corrupt


def _schedule(key, t, m, m_mal, spec, faults, fkey, latency=None):
    """:func:`draw_delays` with the straggler mask as well: ``(delay,
    drop, stale, corrupt)``, one draw of the fault schedule."""
    if latency is not None:
        from attacking_federate_learning_tpu_torch.core.population import (
            traffic_delays
        )
        scales, tail = latency
        delay = traffic_delays(key, t, scales, tail, spec.depth)
    else:
        delay = threefry.randint(threefry.fold_in(key, t), (m,), 0,
                                 spec.depth)
    if faults is not None:
        drop, stale, corrupt = fault_masks(key if fkey is None else fkey, t,
                                           m, m_mal, faults)
        delay = np.where(stale, np.minimum(delay + faults.straggler_delay,
                                           spec.depth - 1), delay)
    else:
        drop = stale = corrupt = np.zeros((m,), bool)
    if spec.timed and m_mal > 0:
        # The timed attacker's rows [0, f) always emit fresh; benign
        # faults still apply (dropout is the network's call).
        delay = delay.copy()
        delay[:m_mal] = 0
    return delay.astype(np.int32), drop, stale, corrupt


def staleness_weights(staleness, delivered, weighting: str):
    """(m,) f32 contribution weights of the delivered rows, zero off the
    mask; None for ``'none'`` (the kernels' unweighted masked path)."""
    if weighting == "none":
        return None
    s = torch.clamp(staleness, min=0).float()
    if weighting == "poly":
        w = 1.0 / torch.sqrt(1.0 + s)
    else:  # 'const'
        w = torch.where(s > 0, 0.5, 1.0)
    return torch.where(delivered, w, 0.0).float()


def async_step(grads, t: int, key, spec: AsyncSpec, state: dict,
               m_mal: int, faults=None, fkey=None, latency=None):
    """One async round against the submitted (m, d) matrix: submit the
    round-t updates into the ring at their drawn slots, take delivery of
    slot ``t % D``, merge the arrivals into the pending pool, evict
    over-stale and quarantine non-finite pending rows, and, once ``k``
    are pending, consume the ``k`` oldest (FIFO).

    ``state`` is updated in place (the ring is 95 MB at n = 100 for
    mnist_mlp; a copy a round would double it).  Returns
    ``(delivered_grads, delivered, staleness, stats)``:

    - ``delivered_grads`` (m, d) f32: the consumed updates, zero outside
      the mask (the distance kernels stay NaN-free);
    - ``delivered`` (m,) bool: the aggregation mask;
    - ``staleness`` (m,) int32: ``t - birth`` on delivered rows, -1
      elsewhere (the ``AttackContext.staleness`` view);
    - ``stats``: ``counts`` (6,) int32 in :data:`COUNT_NAMES` order and
      ``staleness_hist`` (D,) int32 on the device, and with faults the
      host ints ``fault_injected_dropout`` / ``_straggler`` /
      ``_corrupt``."""
    D, m = spec.depth, grads.shape[0]
    dev = grads.device
    k = min(spec.buffer, m)
    delay, drop, stale, corrupt = _schedule(key, t, m, m_mal, spec, faults,
                                            fkey, latency)

    # The written cells (one (slot, row) per submitted row) and the
    # corruption mask cross to the device in one copy, pinned on the card
    # so the host does not wait for the round's earlier kernels.
    rows = np.flatnonzero(~drop)
    host = torch.from_numpy(np.concatenate(
        [(t + delay[rows]) % D, rows, corrupt]).astype(np.int64))
    if dev.type == "cuda":
        host = host.pin_memory()
    cells = host.to(dev, non_blocking=True)
    slots, rows_t = cells[:len(rows)], cells[len(rows):2 * len(rows)]
    corrupt_t = cells[2 * len(rows):].bool()

    submitted = grads.float()
    stats = {}
    if faults is not None:
        if faults.corrupt > 0 and corrupt.any():
            if faults.corrupt_mode == "scale":
                submitted = submitted * torch.where(
                    corrupt_t, faults.corrupt_scale, 1.0)[:, None]
            else:
                bad = {"nan": torch.nan, "inf": torch.inf}[
                    faults.corrupt_mode]
                submitted = torch.where(corrupt_t[:, None], bad, submitted)
        stats.update({"fault_injected_dropout": int(drop.sum()),
                      "fault_injected_straggler": int(stale.sum()),
                      "fault_injected_corrupt": int(corrupt.sum())})

    # --- submit: row i -> ring slot (t + delay_i) % D ----------------------
    buf, occ, birth = state["buf"], state["occ"], state["birth"]
    superseded = occ[slots, rows_t].sum(dtype=torch.int32)
    buf[slots, rows_t] = submitted[rows_t]
    occ[slots, rows_t] = True
    birth[slots, rows_t] = t

    # --- deliver slot t % D, then clear it --------------------------------
    slot = t % D
    arr_occ = occ[slot].clone()
    arr_buf, arr_birth = buf[slot], birth[slot]
    occ[slot] = False

    # --- merge arrivals into the pending pool ------------------------------
    # A client's NEWER computation supersedes its pending older one; an
    # out-of-order late arrival (lower birth) is discarded.  Both count
    # as superseded.
    pbuf, pocc, pbirth = state["pbuf"], state["pocc"], state["pbirth"]
    take = arr_occ & (~pocc | (arr_birth >= pbirth))
    superseded = superseded + (arr_occ & pocc).sum(dtype=torch.int32)
    pbuf.copy_(torch.where(take[:, None], arr_buf, pbuf))
    pbirth.copy_(torch.where(take, arr_birth, pbirth))
    pocc |= arr_occ

    # --- age, evict over-stale, quarantine non-finite ----------------------
    # The server's screen of the pending rows is the ``quarantine`` stage
    # (utils/costs.py); the ring around it is the caller's ``deliver``.
    with stage_scope("quarantine"):
        stal = t - pbirth                               # (m,) int32
        over = pocc & (stal > spec.max_staleness)
        evicted = over.sum(dtype=torch.int32)
        pocc &= ~over
        finite = torch.isfinite(pbuf).all(1)
        quarantined = (pocc & ~finite).sum(dtype=torch.int32)
        pocc &= finite

    # --- FedBuff trigger: the k oldest pending (FIFO) once k are there -----
    ar = torch.arange(m, device=dev)
    order_key = torch.where(pocc, pbirth.to(torch.int64) * m + ar,
                            _EMPTY_KEY)
    idxs = torch.sort(order_key, stable=True).indices[:k]
    live = (order_key[idxs] != _EMPTY_KEY) & (pocc.sum() >= k)
    delivered = torch.zeros((m,), dtype=torch.bool, device=dev)
    delivered[idxs] = live
    delivered_grads = torch.where(delivered[:, None], pbuf, 0.0)
    staleness = torch.where(delivered, stal, -1).to(torch.int32)
    pocc &= ~delivered

    # The staleness histogram of the delivered rows: a fixed (D,) shape.
    hist = ((staleness[None, :] == torch.arange(D, device=dev)[:, None])
            & delivered[None, :]).sum(1, dtype=torch.int32)
    stats["counts"] = torch.stack([
        delivered.sum(dtype=torch.int32), pocc.sum(dtype=torch.int32),
        occ.sum(dtype=torch.int32), evicted, quarantined, superseded])
    stats["staleness_hist"] = hist
    return delivered_grads, delivered, staleness, stats


def weight_mass(staleness, delivered, weights, depth: int):
    """(depth,) f32: the delivered weight in each staleness bucket (unit
    weights under ``'none'``), the 'async' event's ``weight_mass``."""
    w_eff = (weights if weights is not None
             else torch.where(delivered, 1.0, 0.0))
    bucket = staleness[None, :] == torch.arange(
        depth, device=staleness.device)[:, None]
    return (bucket * w_eff[None, :]).sum(1).float()


def replay_schedule(cfg, m, m_mal, epochs, timed=False):
    """Host replay of the delivery dynamics in plain numpy: no gradients,
    only occupancy and ordering, from the same draws as
    :func:`draw_delays`.  One dict a round with the 'async' event's
    counts, the delivered mask and the staleness.  Non-finite rows are
    not modelled (the content-free projection: quarantine needs the
    data)."""
    spec = AsyncSpec(buffer=cfg.async_buffer,
                     max_staleness=cfg.async_max_staleness,
                     weighting=cfg.staleness_weight, timed=timed)
    key = async_key(cfg)
    D = spec.depth
    k = min(spec.buffer, m)
    faults = cfg.faults if (cfg.faults is not None
                            and cfg.faults.enabled) else None
    fkey = None
    if faults is not None:
        from attacking_federate_learning_tpu_torch.core.faults import (
            fault_key
        )
        fkey = fault_key(cfg)
    latency = None
    tr = getattr(cfg, "traffic", None)
    if tr is not None and tr.enabled:
        # The replay draws the heavy-tail latency delays the ring does.
        from attacking_federate_learning_tpu_torch.core.population import (
            async_latency_for_cfg
        )
        latency = async_latency_for_cfg(cfg, m)
    occ = np.zeros((D, m), bool)
    birth = np.zeros((D, m), np.int64)
    pocc = np.zeros((m,), bool)
    pbirth = np.zeros((m,), np.int64)
    rows = []
    for t in range(epochs):
        delay, drop, _ = draw_delays(key, t, m, m_mal, spec, faults, fkey,
                                     latency)
        slots = (t + delay) % D
        superseded = int(occ[slots, np.arange(m)][~drop].sum())
        write = ~drop
        occ[slots[write], np.arange(m)[write]] = True
        birth[slots[write], np.arange(m)[write]] = t
        slot = t % D
        arr = occ[slot].copy()
        occ[slot] = False
        superseded += int((arr & pocc).sum())
        take = arr & (~pocc | (birth[slot] >= pbirth))
        pbirth = np.where(take, birth[slot], pbirth)
        pocc = pocc | arr
        stal = t - pbirth
        over = pocc & (stal > spec.max_staleness)
        evicted = int(over.sum())
        pocc = pocc & ~over
        order_key = np.where(pocc, pbirth * m + np.arange(m), np.inf)
        idxs = np.argsort(order_key, kind="stable")[:k]
        live = np.isfinite(order_key[idxs]) & (int(pocc.sum()) >= k)
        delivered = np.zeros((m,), bool)
        delivered[idxs[live]] = True
        hist = np.zeros((D,), np.int64)
        for s in stal[delivered]:
            if 0 <= s < D:
                hist[s] += 1
        pocc = pocc & ~delivered
        rows.append({
            "delivered": int(delivered.sum()),
            "pending": int(pocc.sum()),
            "in_flight": int(occ.sum()),
            "evicted": evicted,
            "superseded": superseded,
            "staleness_hist": hist.tolist(),
            "delivered_mask": delivered,
            "staleness": np.where(delivered, stal, -1),
        })
    return rows


def check_async_support(cfg):
    """Fail fast on configs the async round cannot honor (engine init),
    with the JAX package's messages (the staged backdoor the config
    refuses already)."""
    if cfg.defense not in MASK_AWARE_DEFENSES:
        raise ValueError(
            f"--aggregation async needs a mask-aware defense "
            f"{MASK_AWARE_DEFENSES}, got {cfg.defense!r} (the delivered-"
            f"cohort mask and staleness weights must reach the kernel; "
            f"defenses/kernels.py)")
    if cfg.participation < 1.0:
        raise ValueError(
            "--aggregation async requires participation=1.0: the "
            "in-flight ring and pending pool are indexed by cohort row, "
            "and under partial participation rows are different clients "
            "each round")
    if cfg.data_placement != "device":
        raise ValueError(
            "--aggregation async requires data_placement='device': the "
            "buffered span is one scanned device program (host "
            "streaming feeds one round per program by design)")
    for name in host_knobs(cfg):
        raise ValueError(
            f"--aggregation async is incompatible with "
            f"{name}='host': the host engines have no mask/weight "
            f"seam (defenses/host.py)")
