"""Fault injection and the pre-aggregation quarantine.

The JAX package's ``core/faults.py``:

- The schedule is a pure function of ``(FaultConfig, seed, round)``:
  :func:`fault_masks` draws it on the host from the JAX package's exact
  threefry bits (utils/threefry.py), three (n,) vectors a round, and the
  masks cross to the device as one small copy.  A host replay of the
  same function says what a run injected.
- :func:`apply_faults` sits on the SUBMITTED matrix, after the attack
  seam: stragglers read a (delay, n, d) ring buffer on the device,
  corruption hits honest rows only (rows >= f, the attack owns [0, f)),
  dropout zeroes a row.
- :func:`quarantine` is the server-side half: it masks non-finite and
  dropped rows, zeroes them (so the distance kernels never see NaN/Inf)
  and hands the effective-cohort mask to the defense's ``mask=`` seam.

Under ``aggregation='async'`` the same schedule composes inside the
buffered round (core/async_rounds.py:async_step): dropout means no
submission, a straggler's update arrives ``straggler_delay`` rounds
later still (so the straggler ring is never built), and corruption hits
honest rows in flight, quarantined at delivery when non-finite.

Under ``aggregation='hierarchical'`` the same discipline has two
granularities (the second half of this module).  Per-client faults draw
per MEGABATCH (:func:`shard_fault_masks`, keyed ``fold_in(fold_in(key,
t), sid)``), and each megabatch's (m,) quarantine mask feeds the
mask-aware tier-1 defense; the straggler ring grows a shard axis,
(delay, S, m, d).  The correlated shard-DOMAIN axis
(``FaultConfig.shard_dropout``) kills whole megabatches for
``shard_dropout_dwell`` rounds (:func:`domain_alive_row`, its own salted
stream): a dead shard reaches tier 2 with an alive count of 0 and is
excluded there.  The tier-2 ladder (:func:`plan_tier2_actions`) plans
remask, fallback (the masked shard median) or hold on the host from the
surviving-shard count; :func:`hier_fault_schedule` is the host ground
truth of a faulted hierarchical run's 'fault' events.

Per-round counts use the JAX 'fault' event's names: ``injected_dropout``,
``injected_straggler`` and ``injected_corrupt`` are host ints (the
schedule is known on the host); ``quarantined`` depends on the data and
stays a device tensor until the caller reads it.
"""

from __future__ import annotations

import numpy as np
import torch

from attacking_federate_learning_tpu_torch.utils import threefry

# Defenses that accept the quarantine mask (the ``mask=`` seam).  A
# defense that averaged zeroed dropout rows would corrupt the aggregate,
# so faults with any other defense are refused up front.
MASK_AWARE_DEFENSES = ("NoDefense", "Krum", "TrimmedMean", "Bulyan",
                       "Median")


def check_fault_support(cfg, participation: float = 1.0):
    """Fail fast on configs the fault model cannot honor, with the JAX
    package's messages; ``participation`` is the cohort share of a round
    (cfg.participation)."""
    if cfg.defense not in MASK_AWARE_DEFENSES:
        raise ValueError(
            f"faults need a mask-aware defense {MASK_AWARE_DEFENSES}, "
            f"got {cfg.defense!r} (the quarantine mask must reach the "
            f"kernel; defenses/kernels.py)")
    if (cfg.faults.shard_dropout > 0
            and cfg.aggregation != "hierarchical"):
        raise ValueError(
            "--fault-shard-dropout models correlated shard-DOMAIN "
            "death and needs --aggregation hierarchical (+ "
            "--megabatch): flat and async rounds have no megabatch/"
            "device domains to kill — use --fault-dropout for "
            "per-client loss there")
    mesh = getattr(cfg, "mesh_shape", None)
    if (cfg.faults.straggler > 0 and cfg.aggregation == "hierarchical"
            and mesh is not None and tuple(mesh)[0] > 1):
        raise ValueError(
            "straggler faults do not compose with the hierarchical "
            "SPMD client_map (--mesh-shape clients axis > 1): the "
            "(delay, S, m, d) stale ring buffer is a cross-round carry "
            "the shard_map program cannot thread — run the sequential "
            "scan (clients axis 1) or drop --fault-straggler "
            "(dropout/corrupt/shard-dropout are stateless and compose)")
    if cfg.faults.straggler > 0 and participation < 1.0:
        raise ValueError(
            "straggler faults need participation=1.0: the stale ring "
            "buffer is indexed by cohort row, and under partial "
            "participation rows are different clients each round; for "
            "a straggler regime the server is designed around, use "
            "--aggregation async instead — there straggler faults "
            "become extra arrival delay in the buffered round "
            "(core/async_rounds.py)")


def fault_key(cfg) -> np.ndarray:
    """The fault schedule's own key, derived from (but distinct from) the
    experiment seed unless FaultConfig.seed overrides it."""
    seed = cfg.faults.seed if cfg.faults.seed is not None else cfg.seed
    return threefry.key(seed ^ 0x0FA7175)


def init_fault_state(faults, m: int, d: int, device) -> dict:
    """``{'stale': (delay, m, d) f32}`` ring buffer on ``device`` when
    stragglers are configured (slot ``t % delay`` holds the cohort's
    submissions from round ``t - delay``), else empty."""
    if faults.straggler > 0:
        return {"stale": torch.zeros((faults.straggler_delay, m, d),
                                     dtype=torch.float32, device=device)}
    return {}


def fault_masks(key: np.ndarray, t: int, m: int, m_mal: int, faults):
    """The round-t schedule: three (m,) numpy bool masks (drop, stale,
    corrupt).  Dropout wins over the other two; corruption draws from
    honest rows only; stragglers are suppressed while the ring buffer is
    cold (t < delay), so the counts describe faults actually applied."""
    k_drop, k_stale, k_corr = threefry.split(threefry.fold_in(key, t), 3)
    drop = threefry.uniform(k_drop, (m,)) < faults.dropout
    stale = (threefry.uniform(k_stale, (m,)) < faults.straggler) & ~drop
    stale = stale & (t >= faults.straggler_delay)
    honest = np.arange(m) >= m_mal
    corrupt = ((threefry.uniform(k_corr, (m,)) < faults.corrupt)
               & ~drop & ~stale & honest)
    return drop, stale, corrupt


def to_device(host: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``, through pinned memory and without a
    synchronization on the card."""
    t = torch.from_numpy(host)
    if torch.device(device).type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


def apply_faults(grads, t: int, key, state: dict, faults, m_mal: int):
    """Inject the round-t faults into the submitted (m, d) matrix.

    Returns ``(faulted, dropped, state, stats)``: ``dropped`` is the (m,)
    bool dropout mask on the device (rows already zeroed), ``stats`` the
    host counts of injected faults.  The ring buffer is updated in place
    (one (m, d) slot a round; a copy would double its 64 MB at the full
    configuration), so ``state`` is the object passed in."""
    m = grads.shape[0]
    drop, stale, corrupt = fault_masks(key, t, m, m_mal, faults)
    masks = to_device(np.stack([drop, stale, corrupt]), grads.device)
    slot = (state["stale"][t % faults.straggler_delay]
            if faults.straggler > 0 else None)
    grads = inject(grads, masks, slot, faults)
    stats = {"injected_dropout": int(drop.sum()),
             "injected_straggler": int(stale.sum()),
             "injected_corrupt": int(corrupt.sum())}
    return grads, masks[0], state, stats


def inject(grads, masks, slot, faults):
    """The injection itself: ``masks`` (3, m) bool on the device (drop,
    stale, corrupt) and ``slot`` the straggler ring's (m, d) slab for
    this round (None without stragglers), updated in place."""
    drop_t, stale_t, corrupt_t = masks
    if faults.straggler > 0:
        # A straggler submits what it computed delay rounds ago; what it
        # computed THIS round enters the buffer for round t + delay.
        faulted = torch.where(stale_t[:, None], slot.to(grads.dtype), grads)
        slot.copy_(grads)
        grads = faulted

    if faults.corrupt > 0:
        if faults.corrupt_mode == "scale":
            scale = torch.where(corrupt_t, faults.corrupt_scale, 1.0)
            grads = grads * scale.to(grads.dtype)[:, None]
        else:
            bad = {"nan": torch.nan, "inf": torch.inf}[faults.corrupt_mode]
            grads = torch.where(corrupt_t[:, None], bad, grads)

    return torch.where(drop_t[:, None], 0.0, grads)


def quarantine(grads, dropped):
    """Pre-aggregation quarantine: non-finite rows (corrupt in flight) and
    dropped rows leave the effective cohort and are zeroed; stale and
    finite bit-scaled rows stay, for the robust aggregation to handle.
    Returns ``(clean, mask, stats)``, ``mask`` (m,) bool True for
    aggregable rows and ``stats['quarantined']`` a 0-d device tensor."""
    mask = torch.isfinite(grads).all(1) & ~dropped
    clean = torch.where(mask[:, None], grads, 0.0)
    return clean, mask, {"quarantined": grads.shape[0] - mask.sum()}


# ---------------------------------------------------------------------------
# hierarchical fault domains

# The domain schedule's own sub-stream, folded once on top of the fault
# key so shard-domain onsets never collide with the per-client draws.
_DOMAIN_SALT = 0x5AD0

# The tier-2 ladder's fallback: when the configured tier-2 defense's
# bound fails against the surviving-shard count, the round degrades to
# the masked shard median.
TIER2_FALLBACK = "Median"


def init_hier_fault_state(faults, num_shards: int, megabatch: int, d: int,
                          device) -> dict:
    """``{'stale': (delay, S, m, d) f32}`` on ``device`` with stragglers
    (slot ``t % delay``, row ``sid`` holds megabatch sid's submissions of
    round ``t - delay``; as many bytes as the flat ring), else empty."""
    if faults.straggler > 0:
        return {"stale": torch.zeros(
            (faults.straggler_delay, num_shards, megabatch, d),
            dtype=torch.float32, device=device)}
    return {}


def shard_fault_masks(key: np.ndarray, t: int, sid: int, m: int,
                      c_mal: int, faults):
    """The (m,) draws of shard ``sid`` at round t, keyed
    ``fold_in(fold_in(key, t), sid)``; the malicious rows are the
    megabatch's first ``c_mal``, so corruption draws from honest rows
    only, as in :func:`fault_masks`."""
    kt = threefry.fold_in(threefry.fold_in(key, t), sid)
    k_drop, k_stale, k_corr = threefry.split(kt, 3)
    drop = threefry.uniform(k_drop, (m,)) < faults.dropout
    stale = (threefry.uniform(k_stale, (m,)) < faults.straggler) & ~drop
    stale = stale & (t >= faults.straggler_delay)
    honest = np.arange(m) >= c_mal
    corrupt = ((threefry.uniform(k_corr, (m,)) < faults.corrupt)
               & ~drop & ~stale & honest)
    return drop, stale, corrupt


def domain_alive_row(key: np.ndarray, t: int, num_shards: int,
                     faults) -> np.ndarray:
    """(S,) bool domain liveness at round t.  Shard s is DEAD iff a death
    onset fired in the dwell window (t - dwell, t]; onsets draw per
    (round, shard) from the ``_DOMAIN_SALT`` sub-stream, rounds before 0
    never fire."""
    alive = np.ones((num_shards,), bool)
    if faults.shard_dropout <= 0:
        return alive
    kd = threefry.fold_in(key, _DOMAIN_SALT)
    for off in range(faults.shard_dropout_dwell):
        t0 = t - off
        if t0 >= 0:
            u = threefry.uniform(threefry.fold_in(kd, t0), (num_shards,))
            alive &= ~(u < faults.shard_dropout)
    return alive


def hier_round_faults(key: np.ndarray, t: int, placement, faults):
    """Round t's whole hierarchical draw on the host: the (S, 3, m) bool
    masks (drop, stale, corrupt) of every shard, the (S,) domain row, and
    the round's :func:`hier_fault_schedule` row."""
    S, m = placement.num_shards, placement.megabatch
    dom = domain_alive_row(key, t, S, faults)
    masks = np.stack([
        np.stack(shard_fault_masks(key, t, sid, m,
                                   placement.mal_counts[sid], faults))
        for sid in range(S)])
    drop, stale, corrupt = masks.transpose(1, 0, 2)
    q = drop | (corrupt if faults.corrupt_mode in ("nan", "inf")
                else np.zeros_like(corrupt))
    alive = (~q).sum(1) * dom
    row = {"round": t,
           "injected_dropout": int(drop.sum()),
           "injected_straggler": int(stale.sum()),
           "injected_corrupt": int(corrupt.sum()),
           "quarantined": int(q.sum()),
           "shards_dead": int(S - dom.sum()),
           "shard_alive": [int(a) for a in alive],
           "shards_alive": int((alive > 0).sum())}
    return masks, dom, row


def apply_shard_faults(grads, masks, slot, faults):
    """Inject one shard's round-t faults into its (m, d) megabatch matrix
    (:func:`inject`): ``masks`` its (3, m) bool draws on the device,
    ``slot`` its straggler ring slab (None without stragglers), which
    takes the pre-fault matrix in place.  Returns ``(faulted,
    dropped)``."""
    return inject(grads, masks, slot, faults), masks[0]


def plan_tier2_actions(shards_alive, tier2_name: str, f2: int,
                       fallback: str = TIER2_FALLBACK) -> np.ndarray:
    """The tier-2 ladder's plan, one action a round from its
    surviving-shard count: the traffic ladder
    (core/population.py:plan_action) with ``f2``, the tier-2 defense's
    static corrupted-shard count, against the surviving shards."""
    from attacking_federate_learning_tpu_torch.core.population import (
        plan_action
    )

    return np.asarray(
        [plan_action(tier2_name, fallback, int(s), int(f2), 1)
         for s in shards_alive], np.int32)


def hier_fault_schedule(key: np.ndarray, t0: int, count: int, placement,
                        faults) -> list:
    """Host replay of the hierarchical fault schedule of rounds [t0,
    t0 + count): per round the injected counts, ``quarantined`` (dropped
    rows plus 'nan'/'inf' corruption; 'scale' stays finite and
    aggregable), ``shards_dead``, ``shard_alive`` (per-shard survivor
    counts after quarantine and domain death) and ``shards_alive``, the
    surviving-shard count the ladder plans on."""
    return [hier_round_faults(key, int(t0) + i, placement, faults)[2]
            for i in range(int(count))]
