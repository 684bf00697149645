"""The flat round's aggregation over the mesh's model axis.

Where the model axis splits d (parallel/mesh.py:MeshPlan.splits), the
JAX package shards the round's (m, d) matrix ``P(clients, model)`` and
lets XLA place each defense's work.  The port places it by hand: the
matrix, gathered to the primary by deliver, is dealt out in column
blocks to the model positions, and

- the coordinate-wise defenses, NoDefense's mean, the trimmed mean
  (kernel 3), the median (kernel 4) and, with a quarantine mask or
  weights, their masked kernels 5 and 6, run on each block on its
  position;
- Krum and Bulyan take their distances from the Gram split over d: each
  position runs stage 1 on its block (ops/distances.py:gram_partials),
  which leaves the block's (n, n) f32 Gram on the position, and stage 2
  on the primary reads the m Grams and sums them in position order
  (gram_epilogue).  The
  selection runs on the primary: Krum's scores by kernel 2's per-row
  selection under the cancellation guard, the exact sort of the same
  matrix where the guard fails (defenses/kernels.py:guarded_scores_of),
  Bulyan's loop as it runs unsplit.  The selected rows, Krum's winner
  and Bulyan's trimmed mean of the picks, are then taken on each block.

The aggregate comes back as column blocks (a :class:`PerPosition`), and
the server step runs on each block (core/engine.py).  Every other
defense, a host engine (a '*_impl' knob set to 'host') and a round with
the observatories on run on the primary over the whole matrix, as they
do without the model axis: :func:`split_defense` returns None for them.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from attacking_federate_learning_tpu_torch.defenses.kernels import (
    DEFENSES, bulyan_select, bulyan_trim, guarded_scores_of, sort_scores
)
from attacking_federate_learning_tpu_torch.ops.distances import (
    gram_epilogue, gram_partials
)
from attacking_federate_learning_tpu_torch.parallel.mesh import (
    MeshPlan, PerPosition
)

# The flat defenses whose work runs on the column blocks.
SPLIT_DEFENSES = ("NoDefense", "TrimmedMean", "Median", "Krum", "Bulyan")
# The config's host-engine knobs: any of them at 'host' keeps the whole
# matrix on the primary.
_HOST_KNOBS = ("distance_impl", "bulyan_selection_impl", "bulyan_trim_impl",
               "trimmed_mean_impl", "median_impl")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _on(device, **kw):
    """The tensors of ``kw`` moved to ``device`` (None dropped)."""
    return {k: v.to(device) for k, v in kw.items() if v is not None}


def split_distances(plan: MeshPlan, blocks, dtype=None) -> torch.Tensor:
    """(n, n) f32 distances on the primary from the model positions'
    column blocks (cast to ``dtype`` first, e.g. a bf16 distance dtype):
    stage 1 on each position, stage 2 on the primary."""
    if dtype is not None:
        blocks = [b.to(dtype).contiguous() for b in blocks]
    return gram_epilogue([gram_partials(b) for b in blocks], plan.primary)


def _coordinatewise(name: str):
    fn = DEFENSES[name]

    def aggregate(plan, grads, n, f, mask=None, weights=None):
        return PerPosition(fn(b, n, f, **_on(b.device, mask=mask,
                                             weights=weights))
                           for b in plan.split_cols(grads))
    return aggregate


def _krum(plan, grads, n, f, mask=None, weights=None, paper_scoring=False,
          distance_dtype=None):
    blocks = plan.split_cols(grads)
    # As unsplit: the fused route takes the wire's dtype, the masked
    # route's distances f32, unless distance_dtype names one.
    if distance_dtype is None and mask is not None:
        distance_dtype = torch.float32
    D = split_distances(plan, blocks, distance_dtype)
    if mask is None:
        scores = guarded_scores_of(D, n, f, paper_scoring)
    else:
        scores = sort_scores(D, mask.sum(), f, paper_scoring, alive=mask)
    idx = torch.argmin(scores)
    out = []
    for b in blocks:
        i = idx.to(b.device)
        out.append(b[i] * weights.to(b.device)[i] if weights is not None
                   else b[i])
    return PerPosition(out)


def _bulyan(plan, grads, n, f, mask=None, weights=None, paper_scoring=False,
            distance_dtype=None, batch_select=1):
    blocks = plan.split_cols(grads)
    D = split_distances(plan, blocks, distance_dtype or torch.float32)
    selected = bulyan_select(D, n, f, paper_scoring, mask, batch_select)
    set_size = n - 2 * f
    out = []
    for b in blocks:
        sel = selected.to(b.device)
        kw = _on(b.device, mask=mask, weights=weights)
        out.append(bulyan_trim(b[sel].contiguous(), sel, set_size, f,
                               **kw)[0])
    return PerPosition(out)


def split_defense(cfg, plan: Optional[MeshPlan], d: int
                  ) -> Optional[Callable]:
    """``fn(plan, grads, n, f, mask=None, weights=None)`` -> the
    aggregate's column blocks, for ``cfg.defense`` over ``plan``'s model
    axis; None where d is not split there or the defense runs whole."""
    if plan is None or not plan.splits(d):
        return None
    if cfg.defense not in SPLIT_DEFENSES:
        return None
    if any(getattr(cfg, k) == "host" for k in _HOST_KNOBS):
        return None
    if cfg.defense in ("Krum", "Bulyan") and cfg.distance_impl in (
            "ring", "allgather"):
        return None
    dist = None if cfg.distance_dtype == "float32" else _DTYPES[
        cfg.distance_dtype]
    if cfg.defense == "Krum":
        return functools.partial(_krum, paper_scoring=cfg.krum_paper_scoring,
                                 distance_dtype=dist)
    if cfg.defense == "Bulyan":
        return functools.partial(_bulyan,
                                 paper_scoring=cfg.krum_paper_scoring,
                                 distance_dtype=dist,
                                 batch_select=cfg.bulyan_batch_select)
    return _coordinatewise(cfg.defense)


def gram_rows(cfg, m: int) -> int:
    """The rows n of the (n, n) f32 Gram each model position sends to the
    primary a round for Krum's or Bulyan's distances (its block's Gram,
    4 n^2 bytes): the cohort m; 0 for the coordinate-wise defenses."""
    return m if cfg.defense in ("Krum", "Bulyan") else 0
