"""Decision-margin reductions and rollups: the margin observatory, the
JAX package's ``utils/margins.py``.

ALIE and Bulyan are margin arguments: the attack works exactly when the
crafted rows sit inside the defense's acceptance region, so the
per-round observable that explains the accuracy cells (the Bulyan IID
z = 1.5 collapse, the femnist_style rescue) is each row's signed
distance to the decision boundary.  Two halves:

- **Device reductions** (fixed shapes, no host read): the rank and
  score algebra of the defenses' ``margins=`` seam (defenses/kernels.py,
  defenses/median.py).  Each mirrors its defense's exact sort and
  selection, so the margins carry identities, not approximations:

  * a row is Krum/Bulyan-selected **iff** its selection margin > 0
    (one-sided at exact f32 score ties, where a winner's margin is 0);
  * a row's trim survival mass equals the telemetry kept fraction bit
    for bit (same keep set, same sum / d).

  The sorts order ties by row index, as JAX's stable ``argsort`` does
  (:func:`stable_argsort`): the keep sets and picks are then JAX's, ties
  included, on every device.

- **Host rollups** (NumPy over event fields): the colluder-survival
  ledger, per-round scalars in DEFENSE sign (``colluder_margin`` > 0:
  every malicious row sits strictly outside the acceptance region;
  <= 0: at least one is inside), and the series/drift helpers.

Sign conventions: per-row ``margin_selection`` is attack-side (positive
means selected); ``colluder_margin = -max(margin_selection[:f])`` is
the defense-side robustness margin.  Boundary distances
(``margin_boundary_dist``) are inside-positive.

Identical crafted colluder rows are score-degenerate: a selected
colluder's runner-up is its identical twin, equal f32 scores subtract
to exactly 0.0, and the margin tie-locks at the boundary.  The science
gate's discriminators are ``margin_tie_rounds`` and
``colluder_selected_total``, not the margin's sign.

This module imports no defense (the defenses import it).
"""

from __future__ import annotations

import math

import numpy as np
import torch


# Margin field names a defense's diagnostics may carry; the engine routes
# exactly these keys into the schema v12 'margin' event.
MARGIN_KEYS = ("margin_selection", "margin_gap", "margin_slack",
               "margin_kept_frac", "margin_boundary_dist",
               "margin_trim_kept")


# --- device reductions (fixed shapes) ------------------------------------


def stable_argsort(x: torch.Tensor) -> torch.Tensor:
    """argsort along axis 0 in JAX's order on every device: ascending in
    its float total order (-0.0 equal to 0.0, every NaN last), ties by
    row index.  The keys are made unique (the value's ordered bits times
    n, plus the row), so the order does not rest on how stable the
    device's sort of a non-last axis is."""
    n = x.shape[0]
    x = x.float() + 0.0                               # -0.0 -> 0.0
    bits = torch.where(torch.isnan(x), torch.nan, x).view(torch.int32)
    bits = bits.to(torch.int64)
    ordered = torch.where(bits < 0, -(bits & 0x7FFFFFFF) - 1, bits)
    rows = torch.arange(n, device=x.device).view((n,) + (1,) * (x.dim() - 1))
    return torch.sort(ordered * n + rows, dim=0).indices


def inverse_permutation(order: torch.Tensor) -> torch.Tensor:
    """Ranks of a permutation along axis 0 (``argsort(order)``, which
    has no ties): ``ranks[order[r, j], j] = r``."""
    n = order.shape[0]
    rows = torch.arange(n, device=order.device).view(
        (n,) + (1,) * (order.dim() - 1)).expand_as(order)
    return torch.empty_like(order).scatter_(0, order, rows)


def mean_as_xla(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.mean`` along ``dim`` as XLA computes it: the sum times the
    f32 reciprocal of the count (not the sum divided by it)."""
    return x.sum(dim) * float(np.float32(1.0 / x.shape[dim]))


def krum_margins(scores, selected_idx, mask=None):
    """Selection margins from a Krum score vector.

    ``margin_selection[i]``: the signed distance of row i's score to the
    selection threshold: for the winner the runner-up score minus its
    own (>= 0), for every other row the winning score minus its own (<=
    0).  ``margin_gap`` is the winner/runner-up gap.  Dead rows under
    ``mask`` are -inf."""
    n = scores.shape[0]
    kk = min(2, n)
    low = torch.sort(scores).values
    s1, s2 = low[0], low[kk - 1]
    rows = torch.arange(n, device=scores.device)
    margin = torch.where(rows == selected_idx, s2, s1) - scores
    if mask is not None:
        margin = torch.where(mask, margin, -torch.inf)
    return {"margin_selection": margin.float(),
            "margin_gap": (s2 - s1).float()}


def rank_keep_margins(key, number_to_consider, order=None):
    """Trim-envelope margins from the (n, d) per-coordinate sort key (|
    deviation from the anchor median|, dead rows at +inf) and the keep
    count (an int or a 0-d tensor):

    - ``margin_kept_frac`` (n,): per row, the fraction of coordinates
      where it survived the trim, from rank membership: bit-equal to
      the telemetry ``kept_fraction`` (the sum of 0/1 values is exact,
      then one division by d);
    - ``margin_boundary_dist`` (n,): per row, the mean over coordinates
      of (trim boundary - key), the boundary the midpoint of the last
      kept and first trimmed keys (the last kept when the first trimmed
      is a +inf sentinel).

    ``order``: the defense's :func:`stable_argsort` of ``key``, if it has
    one."""
    n, d = key.shape
    if order is None:
        order = stable_argsort(key)
    keep = inverse_permutation(order) < number_to_consider
    # Divided by a device tensor: CUDA multiplies by the reciprocal of a
    # Python-number divisor, which is not the division JAX's kept
    # fraction is.
    kept_frac = keep.float().sum(1) / torch.full(
        (), d, dtype=torch.float32, device=key.device)
    srt = key.gather(0, order)
    k = torch.as_tensor(number_to_consider, device=key.device)
    lo = srt[torch.clamp(k - 1, 0, n - 1)]
    hi = srt[torch.clamp(k, 0, n - 1)]
    boundary = torch.where(torch.isfinite(hi), 0.5 * (lo + hi), lo)
    dist = mean_as_xla(boundary[None, :] - key, 1)
    return {"margin_kept_frac": kept_frac.float(),
            "margin_boundary_dist": dist.float()}


def median_pick_margins(users_grads, mask=None, weights=None):
    """Pick-mass margins of the coordinate-wise median, from the exact
    rank membership of the (masked, weighted) median: the same +inf
    sentinel sort, the same middle-rank picks (0.5 / 0.5 on the two
    middles at even alive counts), the same weighted lower-median
    crossing.

    - ``margin_kept_frac`` (n,): per row, the mean over coordinates of
      its pick weight (summing over rows gives 1 a coordinate; the
      picked values reconstruct the aggregate);
    - ``margin_boundary_dist`` (n,): minus the mean |distance to the
      rank-derived median|, dead rows -inf."""
    n = users_grads.shape[0]
    dev = users_grads.device
    alive = (torch.ones(n, dtype=torch.bool, device=dev) if mask is None
             else mask.bool())
    vals = torch.where(alive[:, None], users_grads, torch.inf)
    order = stable_argsort(vals)
    ranks = inverse_permutation(order)
    if weights is not None:
        w = torch.where(alive, weights, 0.0)
        cum = torch.cumsum(w[order], dim=0)
        half = w.sum() / 2.0
        pick_rank = torch.argmax((cum >= half).to(torch.int32), dim=0)
        pick = (ranks == pick_rank[None, :]).float()
    else:
        e = alive.sum()
        lo_r, hi_r = (e - 1) // 2, e // 2
        pick = 0.5 * (ranks == lo_r).float() + 0.5 * (ranks == hi_r).float()
    kept_frac = mean_as_xla(pick, 1)
    med = (torch.where(alive[:, None], users_grads, 0.0) * pick).sum(0)
    dist = -mean_as_xla((users_grads - med[None, :]).abs(), 1)
    dist = torch.where(alive, dist, -torch.inf)
    return {"margin_kept_frac": kept_frac.float(),
            "margin_boundary_dist": dist.float()}


# --- host rollups (NumPy over event fields) ------------------------------


def _finite(a):
    a = np.asarray(a, np.float64)
    return a[np.isfinite(a)]


def margin_rollups(fields, mal_count):
    """Colluder-survival scalars from one round's per-row margin fields
    (rows [0, mal_count) malicious), in DEFENSE sign:

    - ``colluder_margin``: -max over the finite malicious selection
      margins (boundary distances when there is no selection);
    - ``colluder_selected``: malicious rows with selection margin > 0;
    - ``colluder_kept_mass`` / ``honest_kept_mass``: mean surviving
      coordinate mass over malicious / honest rows (Bulyan: its trim
      stage's);
    - ``margin_gap``: the winner/runner-up gap, when scalar."""
    out = {}
    f = int(mal_count)
    sel = fields.get("margin_selection")
    bd = fields.get("margin_boundary_dist")
    basis = sel if sel is not None else bd
    if basis is not None and f > 0:
        mal = _finite(np.asarray(basis, np.float64)[:f])
        if mal.size:
            out["colluder_margin"] = float(-np.max(mal))
    if sel is not None and f > 0:
        out["colluder_selected"] = int(
            np.sum(np.asarray(sel, np.float64)[:f] > 0))
    kept = fields.get("margin_trim_kept", fields.get("margin_kept_frac"))
    if kept is not None:
        kept = np.asarray(kept, np.float64)
        if f > 0:
            out["colluder_kept_mass"] = float(np.mean(kept[:f]))
        if kept.size > f:
            out["honest_kept_mass"] = float(np.mean(kept[f:]))
    gap = fields.get("margin_gap")
    if gap is not None and np.ndim(gap) == 0:
        out["margin_gap"] = float(gap)
    return out


def hier_margin_rollups(stacks, mal_counts):
    """Rollups over a hierarchical round's (S, m) margin stacks (rows
    [0, mal_counts[s]) of shard s malicious): the worst shard margin
    (min), the total selected colluders, the mean kept masses."""
    mal_counts = [int(c) for c in mal_counts]
    margins, selected = [], 0
    kept_c, kept_h = [], []
    any_sel = False
    for s, f_s in enumerate(mal_counts):
        row_fields = {k: np.asarray(v)[s] for k, v in stacks.items()
                      if np.ndim(v) >= 2 or k == "margin_gap"}
        r = margin_rollups(row_fields, f_s)
        if "colluder_margin" in r:
            margins.append(r["colluder_margin"])
        if "colluder_selected" in r:
            any_sel = True
            selected += r["colluder_selected"]
        if "colluder_kept_mass" in r:
            kept_c.append(r["colluder_kept_mass"])
        if "honest_kept_mass" in r:
            kept_h.append(r["honest_kept_mass"])
    out = {}
    if margins:
        out["colluder_margin"] = float(min(margins))
    if any_sel:
        out["colluder_selected"] = int(selected)
    if kept_c:
        out["colluder_kept_mass"] = float(np.mean(kept_c))
    if kept_h:
        out["honest_kept_mass"] = float(np.mean(kept_h))
    return out


def tier2_margin_rollups(fields, colluder_shards):
    """Rollups over the tier-2 margin fields on the (S,) shard axis;
    ``colluder_shards`` marks the shards holding malicious clients (the
    caller prefixes the keys ``tier2_``)."""
    cs = np.asarray(colluder_shards, bool)
    idx = np.flatnonzero(cs)
    out = {}
    sel = fields.get("margin_selection")
    bd = fields.get("margin_boundary_dist")
    basis = sel if sel is not None else bd
    if basis is not None and idx.size:
        mal = _finite(np.asarray(basis, np.float64)[idx])
        if mal.size:
            out["colluder_margin"] = float(-np.max(mal))
    if sel is not None and idx.size:
        out["colluder_selected"] = int(
            np.sum(np.asarray(sel, np.float64)[idx] > 0))
    kept = fields.get("margin_trim_kept", fields.get("margin_kept_frac"))
    if kept is not None and idx.size:
        out["colluder_kept_mass"] = float(
            np.mean(np.asarray(kept, np.float64)[idx]))
    return out


# --- run-level series and drift ------------------------------------------

# Scalar fields of a margin event that trajectories plot, in render order.
SERIES_FIELDS = ("colluder_margin", "colluder_selected",
                 "colluder_kept_mass", "honest_kept_mass", "margin_gap",
                 "f_eff")


def margin_series(events):
    """'margin' events (any order) -> ``{defense: {"round": [...],
    "<field>": [...]}}``, rounds ascending, a missing scalar as None."""
    by_def = {}
    for e in events:
        if e.get("kind") != "margin":
            continue
        by_def.setdefault(str(e.get("defense", "?")), []).append(e)
    out = {}
    for d, rows in by_def.items():
        rows.sort(key=lambda e: int(e.get("round", 0)))
        ser = {"round": [int(e.get("round", 0)) for e in rows]}
        for fld in SERIES_FIELDS:
            ser[fld] = [e.get(fld) for e in rows]
        out[d] = ser
    return out


def margin_drift(series_a, series_b, field="colluder_margin", tol=1e-6):
    """Two :func:`margin_series` entries aligned by round: per-round
    deltas and the rounds where the defense-sign margin flips sign.
    Returns ``{"rounds": [...], "delta": [...], "sign_flips": [...]}``."""
    a_by_r = dict(zip(series_a.get("round", []),
                      series_a.get(field, [])))
    b_by_r = dict(zip(series_b.get("round", []),
                      series_b.get(field, [])))
    rounds = sorted(set(a_by_r) & set(b_by_r))
    deltas, flips = [], []
    for r in rounds:
        va, vb = a_by_r[r], b_by_r[r]
        if va is None or vb is None:
            deltas.append(None)
            continue
        deltas.append(float(vb) - float(va))
        if (math.copysign(1.0, va) != math.copysign(1.0, vb)
                and (abs(va) > tol or abs(vb) > tol)):
            flips.append(r)
    return {"rounds": rounds, "delta": deltas, "sign_flips": flips}
