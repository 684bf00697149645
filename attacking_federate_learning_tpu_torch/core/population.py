"""Client-population registry and the deterministic traffic engine, the
JAX package's ``core/population.py`` (a copy: the port imports nothing of
the JAX package, not even its numpy modules).

- :func:`legacy_cohort` — the ``--participation`` draw of the flat round,
  bit for bit (threefry draws on the host, utils/threefry.py).
- :class:`PopulationRegistry` — P registered clients (P >> cohort m)
  whose per-client state (data-shard archetype, femnist-style transform
  id, reliability, churn dwell and phase, latency scale) is materialized
  LAZILY from splitmix64 streams over (seed, salt, pid), in numpy uint64
  with wraparound.  The registry holds scalars only: no (P,) array ever
  exists on the host or the card.
- The arrival process: a diurnal-modulated base rate, per-client
  blockwise on/off churn (each client holds its availability for
  ``dwell_i`` rounds, a pure function of ``(seed, pid, t)``), and a sybil
  burst window for the colluders.
- The defense-validity watchdog's ladder (:func:`plan_action`): re-mask
  the configured defense to the arrived sub-cohort while its bound holds,
  else the fallback defense, else hold the round.  :func:`traffic_schedule`
  plans cohorts, arrival masks, actions and the v11 'traffic' event
  payloads on the host; :func:`replay_traffic` regenerates them from a
  config alone.
- The async latency profile: :func:`async_latency_for_cfg` and
  :func:`traffic_delays`, a discretized Pareto delay per cohort row drawn
  from the JAX package's threefry bits.

- The hierarchical round's slot resampling (:func:`resample_slots`):
  each megabatch slot re-draws its population archetype every round,
  malicious slots from [0, f) and honest ones from [f, n), with JAX's
  ``randint`` bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from attacking_federate_learning_tpu_torch.utils import threefry

# Degradation-ladder actions, in declared order.  The host watchdog plans
# one action per round.
TRAFFIC_REMASK = 0    # configured defense over the arrived sub-cohort
TRAFFIC_FALLBACK = 1  # bounds-valid fallback defense (trimmed-mean/median)
TRAFFIC_HOLD = 2      # FedBuff-style no-op round (state holds)
ACTION_NAMES = ("remask", "fallback", "hold")

# Validity bounds m_eff >= bound(f) for the mask-aware kernels, with f the
# kernel's STATIC corrupted count (the masked kernels trim and score
# against f rows whatever actually arrived).  Krum uses the selection-
# safety bound 2f+3 (stronger than the 2f+1 it can run at); Bulyan its
# 4f+3; the coordinate trims need 2f+1 rows to leave one; NoDefense
# averages whatever arrived.
DEFENSE_MIN_COHORT = {
    "NoDefense": lambda f: 1,
    "Krum": lambda f: 2 * f + 3,
    "TrimmedMean": lambda f: 2 * f + 1,
    "Median": lambda f: 2 * f + 1,
    "Bulyan": lambda f: 4 * f + 3,
}


def defense_min_cohort(name: str, f: int) -> int:
    return DEFENSE_MIN_COHORT[name](int(f))


def plan_action(defense: str, fallback: str, m_eff: int, f_kernel: int,
                min_cohort: int) -> int:
    """The watchdog's per-round ladder decision (host, schedule time)."""
    if m_eff >= max(min_cohort, defense_min_cohort(defense, f_kernel)):
        return TRAFFIC_REMASK
    if m_eff >= max(min_cohort, defense_min_cohort(fallback, f_kernel)):
        return TRAFFIC_FALLBACK
    return TRAFFIC_HOLD


def traffic_key(cfg) -> np.ndarray:
    """The traffic subsystem's own key (async latency draws), derived from
    (but distinct from) the experiment seed unless TrafficConfig.seed
    overrides it, as core/faults.py:fault_key is."""
    seed = (cfg.traffic.seed if cfg.traffic.seed is not None
            else cfg.seed)
    return threefry.key(seed ^ 0x7AF1C)


def legacy_cohort(part_key: np.ndarray, t: int, n: int, f: int, m: int,
                  m_mal: int) -> np.ndarray:
    """Round-t cohort ids, (m,) int32: the first m_mal are malicious ids
    (< f), the rest honest (>= f) — random identities, static counts.
    ``part_key`` is ``threefry.key(seed ^ 0x9A47)``."""
    k1, k2 = threefry.split(threefry.fold_in(part_key, t))
    mal = threefry.choice(k1, f, m_mal)
    hon = f + threefry.choice(k2, n - f, m - m_mal)
    return np.concatenate([mal, hon]).astype(np.int32)


# --- counter-based PRNG streams (splitmix64, vectorized numpy) --------
# Per-client state is a pure function of (seed, salt, pid[, block]):
# nothing is stored, so the registry stays O(1) however large P grows,
# and the schedule replays identically across process restarts.

_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)

_SALT_SHARD = 1
_SALT_REL = 2
_SALT_DWELL = 3
_SALT_PHASE = 4
_SALT_LAT = 5
_SALT_ON = 6
_SALT_DRAW = 7


def _mix(x):
    # uint64 wraparound is the algorithm; numpy flags scalar overflow
    # (arrays wrap silently): silence it locally, not globally.
    with np.errstate(over="ignore"):
        x = np.asarray(x, np.uint64)
        x = (x ^ (x >> np.uint64(30))) * _M1
        x = (x ^ (x >> np.uint64(27))) * _M2
        return x ^ (x >> np.uint64(31))


def _fold(acc, s):
    with np.errstate(over="ignore"):
        return _mix(np.asarray(acc, np.uint64)
                    ^ (np.asarray(s, np.uint64) + _GAMMA))


def _u01(h):
    # Top 53 bits -> [0, 1) double, the usual splitmix-to-uniform map.
    return (np.asarray(h, np.uint64) >> np.uint64(11)).astype(
        np.float64) * (1.0 / (1 << 53))


@dataclasses.dataclass
class TrafficSchedule:
    """One host-planned span of traffic rounds [t0, t0+count): each
    round's cohort (shard ids, malicious rows first), arrival mask and
    ladder action, plus the per-round 'traffic' event payloads."""

    t0: int
    count: int
    shard_ids: np.ndarray   # (count, m) int32, rows [0, m_mal) malicious
    arrived: np.ndarray     # (count, m) bool — the effective-cohort mask
    action: np.ndarray      # (count,) int32 ladder decision
    events: list            # count dicts (round/arrived/f_eff/action/...)


class PopulationRegistry:
    """Lazy registry of P clients; see the module docstring.

    Colluders are pids [0, F) with F = max(1, round(P*f/n)) (the
    population mirrors the cohort's malicious fraction); a colluder's
    data-shard archetype lands in [0, f), an honest client's in [f, n),
    so a sampled cohort's malicious-first rows keep the engines'
    rows-[0, f) attack invariant, and a population client materializes
    as exactly its archetype's data shard and femnist-style transform.
    """

    def __init__(self, tcfg, n: int, f: int, seed: int):
        self.tcfg = tcfg
        self.n, self.f = int(n), int(f)
        self.P = int(tcfg.population)
        self.F = (max(1, int(round(self.P * f / n))) if f > 0 else 0)
        self.seed = tcfg.seed if tcfg.seed is not None else seed
        self._base = _mix(np.uint64(np.uint64(self.seed) + _GAMMA))

    # -- per-client persistent state (lazy, vectorized) ---------------
    def _h(self, salt, pids, extra=None):
        h = _fold(_fold(self._base, salt), pids)
        if extra is not None:
            h = _fold(h, extra)
        return h

    def client_state(self, pids):
        """Materialize per-client state for the GIVEN pids only."""
        pids = np.asarray(pids, np.int64)
        t = self.tcfg
        malicious = pids < self.F
        shard = np.where(
            malicious,
            self._h(_SALT_SHARD, pids) % np.uint64(max(self.f, 1)),
            np.uint64(self.f)
            + self._h(_SALT_SHARD, pids) % np.uint64(self.n - self.f),
        ).astype(np.int64)
        reliability = (t.reliability_lo
                       + (t.reliability_hi - t.reliability_lo)
                       * _u01(self._h(_SALT_REL, pids)))
        dwell = 1 + (self._h(_SALT_DWELL, pids)
                     % np.uint64(max(t.churn_dwell, 1))).astype(np.int64)
        phase = (self._h(_SALT_PHASE, pids)
                 % dwell.astype(np.uint64)).astype(np.int64)
        # Per-client latency scale, spread around the configured scale so
        # that the Pareto tails differ per client, not just per draw.
        latency = t.latency_scale * (0.5 + 1.0 * _u01(
            self._h(_SALT_LAT, pids)))
        return {"malicious": malicious, "shard": shard,
                "style_id": shard, "reliability": reliability,
                "dwell": dwell, "phase": phase, "latency": latency}

    # -- arrival process ----------------------------------------------
    def arrival_rate(self, t: int) -> float:
        """Diurnal-modulated base arrival rate at round t."""
        tc = self.tcfg
        r = tc.rate * (1.0 + tc.diurnal_amp
                       * np.sin(2.0 * np.pi * t / tc.diurnal_period))
        return float(max(r, 0.0))

    def available(self, pids, t: int, state=None):
        """(len(pids),) bool availability at round t, pure in ``(seed,
        pid, t)``.  Each client's on/off state is drawn once per
        ``dwell_i``-round block; the sybil window reshapes the MALICIOUS
        arrival probability only."""
        pids = np.asarray(pids, np.int64)
        st = state if state is not None else self.client_state(pids)
        tc = self.tcfg
        block = ((t + st["phase"]) // st["dwell"]).astype(np.int64)
        u = _u01(self._h(_SALT_ON, pids, extra=block))
        p_on = np.clip(self.arrival_rate(t) * st["reliability"], 0.0, 1.0)
        if tc.sybil_burst_period > 0:
            in_win = (t % tc.sybil_burst_period) < tc.sybil_burst_width
            gain = tc.sybil_burst_period / tc.sybil_burst_width
            p_mal = np.clip(p_on * gain, 0.0, 1.0) if in_win else 0.0
            p_on = np.where(st["malicious"], p_mal, p_on)
        return u < p_on

    # -- cohort sampling ----------------------------------------------
    def _fill(self, t: int, k: int, malicious: bool):
        """Deterministic rejection-sampled fill of k cohort slots from one
        pool (colluders or honest): hash-drawn candidates, deduplicated,
        arrived first.  When fewer than k candidates arrived, the absent
        candidates keep the static (m,) shape with ``arrived=False``:
        that under-fill is what the watchdog degrades on."""
        if k == 0:
            return (np.zeros(0, np.int64), np.zeros(0, bool))
        lo, hi = (0, self.F) if malicious else (self.F, self.P)
        pool = hi - lo
        budget = max(8 * k, 64)
        salt = np.uint64(_SALT_DRAW + (10 if malicious else 20))
        if pool <= budget:
            # Small pool: a full hashed-order permutation, fresh per t.
            order = self._h(salt, np.arange(lo, hi), extra=t)
            cand = lo + np.argsort(order, kind="stable")
        else:
            j = np.arange(budget, dtype=np.int64)
            draw = lo + (self._h(salt, j, extra=t)
                         % np.uint64(pool)).astype(np.int64)
            _, first = np.unique(draw, return_index=True)
            cand = draw[np.sort(first)]
        avail = self.available(cand, t)
        here = cand[avail][:k]
        absent = cand[~avail][: k - len(here)]
        if len(here) + len(absent) < k:
            # Pathological (tiny pool): repeat candidates to keep the
            # static shape.
            pad = np.resize(cand, k - len(here) - len(absent))
            absent = np.concatenate([absent, pad])
        pids = np.concatenate([here, absent])[:k]
        arrived = np.zeros(k, bool)
        arrived[: len(here)] = True
        return pids.astype(np.int64), arrived

    def sample_cohort(self, t: int, m: int, m_mal: int):
        """Round-t cohort: (shard_ids (m,) int32 malicious-first, arrived
        (m,) bool, pids (m,) int64)."""
        mal_p, mal_a = self._fill(t, m_mal, malicious=True)
        hon_p, hon_a = self._fill(t, m - m_mal, malicious=False)
        pids = np.concatenate([mal_p, hon_p])
        arrived = np.concatenate([mal_a, hon_a])
        shard_ids = self.client_state(pids)["shard"].astype(np.int32)
        return shard_ids, arrived, pids


def traffic_schedule(registry: PopulationRegistry, t0: int, count: int,
                     m: int, m_mal: int, defense: str, fallback: str,
                     min_cohort: int) -> TrafficSchedule:
    """Host-planned schedule for rounds [t0, t0+count): cohorts, arrival
    masks, ladder actions and the 'traffic' event payloads.  Pure in
    (registry config, t), so a resumed run regenerates its tail bit for
    bit and :func:`replay_traffic` can diff the emitted events."""
    sids = np.zeros((count, m), np.int32)
    arr = np.zeros((count, m), bool)
    act = np.zeros((count,), np.int32)
    events = []
    for i in range(count):
        t = t0 + i
        sid, a, _pids = registry.sample_cohort(t, m, m_mal)
        sids[i], arr[i] = sid, a
        m_eff = int(a.sum())
        f_eff = int(a[:m_mal].sum())
        action = plan_action(defense, fallback, m_eff, m_mal, min_cohort)
        act[i] = action
        events.append({
            "round": int(t),
            "arrived": m_eff,
            "f_eff": f_eff,
            "cohort": int(m),
            "action": ACTION_NAMES[action],
            "defense": (defense if action == TRAFFIC_REMASK
                        else fallback if action == TRAFFIC_FALLBACK
                        else "none"),
        })
    return TrafficSchedule(t0=int(t0), count=int(count), shard_ids=sids,
                           arrived=arr, action=act, events=events)


def replay_traffic(cfg, epochs: int):
    """Regenerate the full traffic schedule's 'traffic' events of a run
    from its config alone: the events a run emitted must equal these."""
    n, f = cfg.users_count, cfg.corrupted_count
    if cfg.participation < 1.0:
        m = max(1, int(round(cfg.participation * n)))
        m_mal = min(int(round(cfg.participation * f)), m)
    else:
        m, m_mal = n, f
    reg = PopulationRegistry(cfg.traffic, n, f, cfg.seed)
    sched = traffic_schedule(reg, 0, epochs, m, m_mal, cfg.defense,
                             cfg.traffic.fallback_defense,
                             cfg.traffic.min_cohort)
    return sched.events


# --- async latency profile (core/async_rounds.py:draw_delays) ---------
def async_latency_for_cfg(cfg, m: int):
    """(scales (m,) f32 numpy, tail float) for the async heavy-tail delay
    draw: cohort row i is population client i for the malicious rows and
    F + (i - m_mal) for the honest ones (the async ring is resident, so
    the row-to-pid map is fixed), each with its lazily derived latency
    scale."""
    f = cfg.corrupted_count
    reg = PopulationRegistry(cfg.traffic, cfg.users_count, f, cfg.seed)
    m_mal = min(f, m)
    pids = np.concatenate([np.arange(m_mal),
                           reg.F + np.arange(m - m_mal)])
    scales = reg.client_state(pids)["latency"].astype(np.float32)
    return scales, float(cfg.traffic.latency_tail)


def traffic_delays(key, t: int, scales, tail: float, depth: int):
    """Heavy-tail straggler delay per cohort row, (m,) int32 on the host:
    a discretized Pareto(tail) draw scaled by the per-client latency
    profile, clipped to the delivery ring's depth — the JAX package's
    ``uniform(fold_in(key, t), minval=1e-6, maxval=1)``, then
    ``scales * (u ** (-1 / tail) - 1)`` in f32, clipped and truncated.

    The uniform is JAX's bit for bit (utils/threefry.py).  The f32 power
    is torch's: XLA's differs from it by one ulp in about 2 % of values,
    which changes a delay only where the scaled value lies within an ulp
    of an integer (none in 6 million draws against the JAX function)."""
    f32 = np.float32
    kt = threefry.fold_in(key, t)
    lo, hi = f32(1e-6), f32(1.0)
    u = np.maximum(lo, threefry.uniform(kt, np.shape(scales)) * (hi - lo)
                   + lo)
    p = torch.pow(torch.from_numpy(u), -1.0 / tail).numpy()
    raw = np.asarray(scales, f32) * (p - f32(1.0))
    return np.clip(raw, f32(0), f32(depth - 1)).astype(np.int32)


def resample_slots(key: np.ndarray, t: int, ids: np.ndarray, c_mal: int,
                   f: int, n: int) -> np.ndarray:
    """One megabatch's client slots resampled for round t (the
    hierarchical round under traffic): malicious slots (the first
    ``c_mal``) draw a shard archetype from [0, f), honest slots from
    [f, n).  Rounds stay full and the ladder does not apply: this is
    cohort identity only.  Pure in ``(key, t, ids[0])`` (placement id
    sets are disjoint, so the first id decorrelates megabatches)."""
    kt = threefry.fold_in(threefry.fold_in(key, t), int(ids[0]))
    k1, k2 = threefry.split(kt)
    mal = threefry.randint(k1, ids.shape, 0, max(f, 1))
    hon = f + threefry.randint(k2, ids.shape, 0, n - f)
    slot_mal = np.arange(ids.shape[0]) < c_mal
    return np.where(slot_mal, mal, hon).astype(ids.dtype)


def check_traffic_support(cfg):
    """Fail fast on configs the traffic engine cannot honor (engine
    init), with the JAX package's messages.  Knobs the port's config does
    not have (secagg, host streaming, the host kernels, the SPMD mesh)
    are read where a config carries them, so a JAX config is held to the
    same checks."""
    from attacking_federate_learning_tpu_torch.core.faults import (
        MASK_AWARE_DEFENSES
    )

    t = cfg.traffic
    if t.population < cfg.users_count:
        raise ValueError(
            f"--traffic-population must cover the cohort pool: "
            f"P={t.population} < users_count={cfg.users_count} (the "
            f"registry's shard archetypes span all n clients)")
    if getattr(cfg, "secagg", "off") != "off":
        raise ValueError(
            "--traffic-population is incompatible with --secagg: "
            "pairwise masks are keyed on client identity, and sampled "
            "population cohorts re-key every row each round (the same "
            "structural fact that rejects --participation there)")
    if getattr(cfg, "data_placement", "device") != "device":
        raise ValueError(
            "--traffic-population requires data_placement='device': "
            "the traffic schedule rides the scanned span as per-round "
            "scan inputs; the streaming mode feeds one round per "
            "program by design")
    if cfg.backdoor and not cfg.backdoor_fused:
        raise ValueError(
            "--traffic-population needs the fused backdoor path (drop "
            "--backdoor-staged): cohort sampling, the arrival mask and "
            "the degradation ladder all live inside the fused round "
            "program")
    if cfg.aggregation == "hierarchical":
        mesh = getattr(cfg, "mesh_shape", None)
        if mesh is not None and tuple(mesh)[0] > 1:
            raise ValueError(
                "--traffic-population with hierarchical aggregation "
                "does not compose with the SPMD client_map "
                "(--mesh-shape clients axis > 1): the per-round slot "
                "resampling draws keys inside the scanned megabatch "
                "body, which the shard_map program does not thread yet")
        return
    if cfg.aggregation == "async":
        return
    # Flat: the arrival mask and the ladder ride the mask-aware seam.
    if cfg.defense not in MASK_AWARE_DEFENSES:
        raise ValueError(
            f"--traffic-population needs a mask-aware defense "
            f"{MASK_AWARE_DEFENSES}, got {cfg.defense!r} (the arrival "
            f"mask must reach the kernel; defenses/kernels.py)")
    if t.fallback_defense not in MASK_AWARE_DEFENSES:
        raise ValueError(
            f"--traffic-fallback must be mask-aware "
            f"{MASK_AWARE_DEFENSES}, got {t.fallback_defense!r}")
    host_impls = [
        ("distance_impl", getattr(cfg, "distance_impl", "auto")),
        ("trimmed_mean_impl", getattr(cfg, "trimmed_mean_impl", "xla")),
        ("median_impl", getattr(cfg, "median_impl", "xla")),
        ("bulyan_selection_impl",
         getattr(cfg, "bulyan_selection_impl", "xla")),
        ("bulyan_trim_impl", getattr(cfg, "bulyan_trim_impl", "xla")),
    ]
    for name, val in host_impls:
        if val == "host":
            raise ValueError(
                f"--traffic-population is incompatible with "
                f"{name}='host': the host engines have no mask seam "
                f"(defenses/host.py)")
