"""Numerics and determinism observatory, the JAX package's
``utils/numerics.py``: f32 behaviour as an observable, in three layers.

- **Device counters** (fixed shapes, no host read): non-finite counts by
  stage, the gradient-norm dynamic range, cancellation-depth estimates
  on the distance Gram, and tie-proximity counters that band the margin
  tensors (utils/margins.py) at k ulp of the boundary's own scale: no
  new O(n^2 d) work.  The engine emits one schema-v14 'numerics' event a
  round (core/engine.py).
- **Host ulp machinery** (NumPy): the monotone f32 ordinal, elementwise
  and max ulp distances, and the f64-refereed verdict for a pair of
  implementations on the same inputs (:func:`adjudicate`).
- **Reader helpers**: per-round series, the field -> stage attribution
  and the host rollups of the event emitter.

Row norms here are ``sqrt(sum(x * x))`` (:func:`row_norms`): on the CPU
``torch.linalg.vector_norm`` of an f32 row is about 1e-6 away from XLA's,
the plain sum within an ulp or two.

This module imports no defense (the defenses import it).
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Default tie band: a decision whose margin sits within this many ulp (at
# the boundary's own magnitude) of zero is one that a legal 1-ulp change
# of evaluation order could flip.
TIE_BAND_ULPS = 8

_EPS32 = 2.0 ** -23           # f32 machine epsilon (ulp at 1.0)
_TINY32 = 2.0 ** -126         # smallest normal f32


# --- device counters (fixed shapes) ---------------------------------------


def row_norms(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """f32 L2 norms along ``dim``: the square root of the plain sum of
    squares."""
    x = x.float()
    return (x * x).sum(dim).sqrt()


def nonfinite_count(x, mask=None):
    """() int32 count of the non-finite entries of ``x`` (f32 view);
    ``mask`` (n,) keeps an (n, d) matrix's alive rows only."""
    bad = ~torch.isfinite(x.float())
    if mask is not None:
        bad = bad & (mask[:, None] if bad.dim() == 2 else mask)
    return bad.sum().to(torch.int32)


def norm_dynamic_range(x, mask=None):
    """() f32 log2(max / min) over the finite nonzero row norms of the
    (n, d) matrix; 0.0 with fewer than two usable rows."""
    norms = row_norms(x)
    ok = torch.isfinite(norms) & (norms > 0)
    if mask is not None:
        ok = ok & mask
    hi = torch.where(ok, norms, -torch.inf).max()
    lo = torch.where(ok, norms, torch.inf).min()
    usable = torch.isfinite(hi) & torch.isfinite(lo) & (lo > 0)
    rng = (torch.log2(torch.clamp(hi, min=_TINY32))
           - torch.log2(torch.clamp(lo, min=_TINY32)))
    return torch.where(usable, rng, 0.0).float()


def max_finite_abs(x):
    """() f32 largest finite |entry| of ``x`` (the trim stage's tie-band
    scale; +inf sentinels excluded); 0.0 when nothing is finite."""
    a = torch.as_tensor(x).float().abs()
    m = torch.where(torch.isfinite(a), a, -torch.inf).max()
    return torch.where(torch.isfinite(m), m, 0.0).float()


def ulp_at(scale):
    """f32 spacing at magnitude |scale| (eps |scale|, floored at the
    smallest normal)."""
    s = torch.as_tensor(scale, dtype=torch.float32).abs()
    return torch.clamp(s * _EPS32, min=_TINY32)


def tie_proximity(margin, scale, k=TIE_BAND_ULPS):
    """() int32 count of the finite margin entries within ``k`` ulp (at
    the boundary scale) of zero: decisions a k-ulp change of evaluation
    could flip."""
    band = float(k) * ulp_at(scale)
    m = torch.as_tensor(margin).float()
    near = torch.isfinite(m) & (m.abs() <= band)
    return near.sum().to(torch.int32)


def cancellation_bits(max_term, min_positive):
    """() f32 log2(largest accumulated term / smallest positive result):
    the bits an ||a||^2 + ||b||^2 - 2ab subtraction cancelled."""
    mt = torch.clamp(torch.as_tensor(max_term, dtype=torch.float32).abs(),
                     min=_TINY32)
    mp = torch.clamp(torch.as_tensor(min_positive,
                                     dtype=torch.float32).abs(),
                     min=_TINY32)
    return torch.clamp(torch.log2(mt) - torch.log2(mp), min=0.0).float()


def gram_cancellation_bits(Dm, mask=None):
    """Cancellation depth over an (n, n) squared-distance matrix (+inf
    diagonal): the largest finite entry against the smallest positive
    one, dead rows excluded pairwise; 0.0 without a positive finite
    distance."""
    Df = Dm.float()
    finite = torch.isfinite(Df)
    if mask is not None:
        finite = finite & (mask[:, None] & mask[None, :])
    pos = finite & (Df > 0)
    any_pos = pos.any()
    one = torch.ones((), dtype=torch.float32, device=Df.device)
    min_pos = torch.where(pos, Df, torch.inf).min()
    max_fin = torch.where(finite, Df, -torch.inf).max()
    bits = cancellation_bits(torch.where(any_pos, max_fin, one),
                             torch.where(any_pos, min_pos, one))
    return torch.where(any_pos, bits, 0.0)


# --- host ulp machinery (NumPy) -------------------------------------------


def f32_ords(a):
    """Monotone int64 ordinal of each value on the f32 lattice: adjacent
    representable f32 values differ by exactly 1."""
    bits = np.ascontiguousarray(
        np.asarray(a, np.float32)).view(np.uint32).astype(np.int64)
    return np.where(bits < 0x80000000, bits, 0x80000000 - bits)


def ulp_diff(a, b):
    """Elementwise f32 ulp distance (int64); NaN vs NaN is 0, NaN vs a
    number the sentinel 2**31."""
    af = np.asarray(a, np.float32).ravel()
    bf = np.asarray(b, np.float32).ravel()
    d = np.abs(f32_ords(af) - f32_ords(bf))
    na, nb = np.isnan(af), np.isnan(bf)
    d = np.where(na & nb, 0, d)
    d = np.where(na ^ nb, np.int64(2) ** 31, d)
    return d


def max_ulp(a, b):
    """(max ulp distance, its flat coordinate); (0, -1) for empty or
    bit-identical inputs."""
    d = ulp_diff(a, b)
    if d.size == 0 or not d.any():
        return 0, -1
    i = int(np.argmax(d))
    return int(d[i]), i


def adjudicate(a, b, oracle64, band_ulps=TIE_BAND_ULPS):
    """The f64-refereed verdict for one pair of implementations on the
    same inputs (``oracle64``: the f64 result, defenses/oracle.py).
    Returns ``max_ulp``, ``n_mismatch``, ``argmax_coord``, ``in_tie_band``
    (every divergent coordinate within ``band_ulps`` of both the other
    and the oracle), ``band_ulps`` and ``verdict``: 'exact', 'tie_band',
    'a_closer' / 'b_closer' (one strictly nearer the f64 truth on the
    divergent coordinates) or 'split'."""
    a32 = np.asarray(a, np.float32).ravel()
    b32 = np.asarray(b, np.float32).ravel()
    oc = np.asarray(oracle64, np.float64).ravel().astype(np.float32)
    d = ulp_diff(a32, b32)
    mis = np.nonzero(d)[0]
    rec = {"max_ulp": 0, "n_mismatch": 0, "argmax_coord": -1,
           "in_tie_band": True, "verdict": "exact",
           "band_ulps": int(band_ulps)}
    if mis.size == 0:
        return rec
    i = int(np.argmax(d))
    da = ulp_diff(a32, oc)[mis]
    db = ulp_diff(b32, oc)[mis]
    in_band = bool(int(d.max()) <= band_ulps
                   and int(max(da.max(), db.max())) <= band_ulps)
    if in_band:
        verdict = "tie_band"
    elif int(np.sum(da < db)) and not int(np.sum(db < da)):
        verdict = "a_closer"
    elif int(np.sum(db < da)) and not int(np.sum(da < db)):
        verdict = "b_closer"
    else:
        verdict = "split"
    rec.update(max_ulp=int(d[i]), n_mismatch=int(mis.size),
               argmax_coord=i, in_tie_band=in_band, verdict=verdict)
    return rec


# --- event-side helpers ----------------------------------------------------

# Per-round 'numerics' fields a reader can series (hierarchical stacks
# carry shard_ / tier2_ prefixes on the same names).
SERIES_FIELDS = ("nonfinite_pre", "nonfinite_post", "nonfinite_agg",
                 "range_log2", "tie_rows", "cancel_bits",
                 "nonfinite_total", "tie_locked")

# The pipeline stage each counter observes.
FIELD_STAGE = {
    "nonfinite_pre": "deliver",          # the post-attack wire matrix
    "range_log2": "deliver",
    "nonfinite_post": "quarantine",      # the post-quarantine matrix
    "tie_rows": "tier1_aggregate",       # the selection/trim boundary
    "cancel_bits": "tier1_aggregate",    # the distance Gram
    "nonfinite_agg": "apply",            # the applied update
    "nonfinite_total": "apply",
    "tie_locked": "tier1_aggregate",
}

_MARGIN_STAGE_DEFAULT = "tier1_aggregate"


def stage_of(field, kind="numerics"):
    """The stage a diverging margin/numerics event field observes."""
    f = str(field)
    if f.startswith("tier2_"):
        return "tier2_aggregate"
    if f.startswith("shard_"):
        f = f[len("shard_"):]
    if kind == "margin":
        return ("deliver" if f.startswith("attack_")
                else _MARGIN_STAGE_DEFAULT)
    return FIELD_STAGE.get(f, "tier1_aggregate")


def field_ulp(a, b):
    """Ulp distance between two JSON payload values (numbers or flat
    numeric lists of one length); None when not comparable so."""
    num = (int, float)
    if (isinstance(a, num) and isinstance(b, num)
            and not isinstance(a, bool) and not isinstance(b, bool)):
        return int(ulp_diff([a], [b])[0])
    if (isinstance(a, list) and isinstance(b, list)
            and len(a) == len(b) and a
            and all(isinstance(x, num) for x in a)
            and all(isinstance(x, num) for x in b)):
        return int(ulp_diff(a, b).max())
    return None


def divergence_attribution(fields, kind="numerics"):
    """For a ``{field: [va, vb]}`` divergence map of a margin/numerics
    event: (stage, max ulp over the comparable fields, the field that
    carries it); the ulp is None when no field is comparable."""
    best_field, best_ulp = None, None
    for k in sorted(fields):
        va, vb = fields[k]
        u = field_ulp(va, vb)
        if u is not None and (best_ulp is None or u > best_ulp):
            best_field, best_ulp = k, u
    anchor = best_field if best_field is not None else sorted(fields)[0]
    return stage_of(anchor, kind=kind), best_ulp, anchor


def _base(k):
    for tier in ("shard_", "tier2_"):
        if k.startswith(tier):
            return k[len(tier):]
    return k


def numerics_rollups(fields):
    """The host summary merged into a round's 'numerics' event: the
    non-finite total across stages and the tie-lock flag (any decision
    within the tie band this round)."""
    total = 0
    locked = 0
    for k, v in fields.items():
        base = _base(k)
        if base.startswith("nonfinite"):
            if isinstance(v, list):
                total += int(sum(x for x in v
                                 if isinstance(x, (int, float))
                                 and math.isfinite(x)))
            elif isinstance(v, (int, float)) and math.isfinite(v):
                total += int(v)
        if base == "tie_rows":
            vs = v if isinstance(v, list) else [v]
            if any(isinstance(x, (int, float)) and x > 0 for x in vs):
                locked = 1
    return {"nonfinite_total": total, "tie_locked": locked}


def numerics_series(events):
    """``{field: [(round, value), ...]}`` over a run's 'numerics' events,
    rounds ascending (a hierarchical stack reduced to its max)."""
    rows = sorted((e for e in events if e.get("kind") == "numerics"),
                  key=lambda e: e.get("round", 0))
    out = {}
    for e in rows:
        r = e.get("round")
        if not isinstance(r, (int, float)):
            continue
        for f in SERIES_FIELDS:
            for key in (f, "shard_" + f, "tier2_" + f):
                v = e.get(key)
                if isinstance(v, list):
                    vs = [x for x in v if isinstance(x, (int, float))
                          and math.isfinite(x)]
                    v = max(vs) if vs else None
                if isinstance(v, (int, float)) and math.isfinite(v):
                    out.setdefault(key, []).append((int(r), v))
    return out


def numerics_drift(series_a, series_b, field="tie_rows"):
    """The first round where two runs' series of ``field`` differ, as
    (round, value_a, value_b); None when every shared round agrees."""
    da = dict(series_a.get(field, ()))
    db = dict(series_b.get(field, ()))
    for r in sorted(set(da) & set(db)):
        if da[r] != db[r]:
            return int(r), da[r], db[r]
    return None
