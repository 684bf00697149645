"""Fault injection and the pre-aggregation quarantine of the flat round.

The JAX package's ``core/faults.py``, flat half (the hierarchical fault
domains belong to the hierarchical slice of the port):

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
    if cfg.faults.shard_dropout > 0:
        raise ValueError(
            "--fault-shard-dropout models correlated shard-DOMAIN "
            "death and needs --aggregation hierarchical (+ "
            "--megabatch): flat and async rounds have no megabatch/"
            "device domains to kill — use --fault-dropout for "
            "per-client loss there")
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


def apply_faults(grads, t: int, key, state: dict, faults, m_mal: int):
    """Inject the round-t faults into the submitted (m, d) matrix.

    Returns ``(faulted, dropped, state, stats)``: ``dropped`` is the (m,)
    bool dropout mask on the device (rows already zeroed), ``stats`` the
    host counts of injected faults.  The ring buffer is updated in place
    (one (m, d) slot a round; a copy would double its 64 MB at the full
    configuration), so ``state`` is the object passed in."""
    m = grads.shape[0]
    drop, stale, corrupt = fault_masks(key, t, m, m_mal, faults)
    masks = torch.from_numpy(np.stack([drop, stale, corrupt]))
    if grads.device.type == "cuda":
        masks = masks.pin_memory().to(grads.device, non_blocking=True)
    drop_t, stale_t, corrupt_t = masks

    if faults.straggler > 0:
        # A straggler submits what it computed delay rounds ago; what it
        # computed THIS round enters the buffer for round t + delay.
        slot = state["stale"][t % faults.straggler_delay]
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

    grads = torch.where(drop_t[:, None], 0.0, grads)
    stats = {"injected_dropout": int(drop.sum()),
             "injected_straggler": int(stale.sum()),
             "injected_corrupt": int(corrupt.sum())}
    return grads, drop_t, state, stats


def quarantine(grads, dropped):
    """Pre-aggregation quarantine: non-finite rows (corrupt in flight) and
    dropped rows leave the effective cohort and are zeroed; stale and
    finite bit-scaled rows stay, for the robust aggregation to handle.
    Returns ``(clean, mask, stats)``, ``mask`` (m,) bool True for
    aggregable rows and ``stats['quarantined']`` a 0-d device tensor."""
    mask = torch.isfinite(grads).all(1) & ~dropped
    clean = torch.where(mask[:, None], grads, 0.0)
    return clean, mask, {"quarantined": grads.shape[0] - mask.sum()}
