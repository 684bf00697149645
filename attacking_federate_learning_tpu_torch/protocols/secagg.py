"""Simulated secure aggregation: pairwise masks that cancel bit-exactly,
the JAX package's ``protocols/secagg.py`` on tensors.

Every pair of clients (i, j) shares a mask; the lower id adds it, the
higher subtracts it, and the masks cancel in the server's sum (Bonawitz
et al., arXiv 1611.04482).  As in the JAX package:

- **Masking lives in the uint32 bitcast domain.**  An f32 row's bits
  (``.view(torch.int32)``, never ``.to()``, so NaN and Inf patterns
  survive) take the net mask by mod-2**32 addition, which is exactly
  invertible and associative: the recovered rows are the clear rows bit
  for bit, and a masked run is bit-equal to its clear twin.
- **Masks are derived, never stored.**  The pair {i, j} of round t draws
  ``jax.random.bits(fold_in(fold_in(fold_in(key, t), lo), hi))`` (lo, hi
  the smaller and larger id), so a resumed run re-derives them and the
  groupwise mode keys them on global client ids.
- **Dropout is a protocol event.**  A dropped client never submits its
  wire; :func:`recovery_residue` re-derives its (alive, dropped) pair
  masks, and the sum check ``modsum(wire[alive]) - residue ==
  modsum(clear[alive])`` holds bitwise.

The round's arithmetic runs in three kernels (ops/secagg_masks.py;
plain versions on the CPU): the net masks, the residue (in every round
with an alive mask, as in the JAX package) and one pass that builds the wire, checks the sums and recovers
the rows.  The pair keys are drawn on the host (utils/threefry.py
:func:`pair_keys`) and cross to the device in one copy.  The sum check
and the counts stay on the device as int32 tensors, for the engine to
read at its host boundaries.  Here the wire exists inside that one pass
(the kernel's empty asm is the network); :func:`mask_rows`,
:func:`unmask_rows` and :func:`modular_sum` are its steps on their own,
in plain PyTorch.

Not here: ``wire_hlo_facts`` (a parser of XLA's HLO, which the port
does not have).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from attacking_federate_learning_tpu_torch.core.faults import to_device
from attacking_federate_learning_tpu_torch.ops import secagg_masks as K
from attacking_federate_learning_tpu_torch.utils import threefry
from attacking_federate_learning_tpu_torch.utils.costs import stage_scope
from attacking_federate_learning_tpu_torch.utils.numerics import row_norms

SECAGG_MODES = ("off", "vanilla", "groupwise")

_MASK = 0xFFFFFFFF


def secagg_key(cfg) -> np.ndarray:
    """The protocol's own key stream, from the experiment seed: the JAX
    package's ``jax.random.key(seed ^ 0x5EC466)`` as (2,) uint32."""
    return threefry.key(cfg.seed ^ 0x5EC466)


def round_tables(key_t: np.ndarray, ids, device):
    """The kernels' tables for the ids ``ids`` ((n,) or (..., n) host
    ints) under the round key ``key_t``: the pair keys, (..., P, 2)
    int32, and the ids, int64, on ``device``, each in one copy."""
    ids = np.asarray(ids, np.int64)
    keys = threefry.pair_keys(key_t, ids).view(np.int32)
    return (to_device(np.ascontiguousarray(keys), device),
            to_device(np.ascontiguousarray(ids), device))


def pairwise_deltas(key_t: np.ndarray, ids, d: int,
                    device="cpu") -> torch.Tensor:
    """Per-row net masks ``delta_a = sum_b sign(a, b) m_ab`` (mod 2**32)
    over every pair of ``ids`` ((n,) host ints), sign +1 where ids[a] <
    ids[b]: (n, d) int32 bit patterns on ``device``."""
    return K.secagg_deltas(*round_tables(key_t, ids, device), d)


def mask_rows(grads: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Client side: each f32 row's bits plus its net mask, mod 2**32: the
    (n, d) int32 wire."""
    bits = K.from_words(grads.float().contiguous().view(torch.int32))
    return K.to_words((bits + K.from_words(deltas)) & _MASK)


def unmask_rows(wire: torch.Tensor, deltas: torch.Tensor,
                alive: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The exact inverse of :func:`mask_rows`, as f32 rows; rows not
    ``alive`` never submitted and come back zeroed."""
    bits = K.to_words((K.from_words(wire) - K.from_words(deltas)) & _MASK)
    clear = bits.view(torch.float32)
    if alive is not None:
        clear = torch.where(alive[:, None], clear, 0.0)
    return clear


def modular_sum(bits: torch.Tensor,
                alive: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mod-2**32 column sum of int32 words (the alive rows only), as
    int32."""
    words = K.from_words(bits)
    if alive is not None:
        words = words * alive[:, None]
    return K.to_words(words.sum(0) & _MASK)


def recovery_residue(key_t: np.ndarray, ids, alive: torch.Tensor, d: int):
    """The simulated seed-reveal round: the (d,) int32 net mask of every
    (alive, dropped) pair, from the alive side, and the pair count."""
    return K.secagg_residue(*round_tables(key_t, ids, alive.device), alive,
                            d)


def unmask_sum(grads: torch.Tensor, deltas: torch.Tensor,
               alive: Optional[torch.Tensor], tables, ok=None, count=None):
    """Server side of the protocol round: the wire is ``grads``' bits plus
    ``deltas``; recover the aggregable matrix and verify exact sum
    recovery bitwise.  ``tables`` are the round's :func:`round_tables`;
    ``alive`` None means every client submitted; with ``alive``, the
    residue of the dead rows' pairs is re-derived.  ``ok`` and ``count``
    are int32 elements on the device that take the sum check (ANDed in)
    and the pair count.  Returns ``(recovered (n, d) f32, stats)``: the
    JAX package's four ``secagg_*`` stats, int32 device tensors."""
    d, dev = grads.shape[1], grads.device
    if alive is None:
        residue = None
        dropped = torch.zeros((), dtype=torch.int32, device=dev)
        pairs = dropped if count is None else count.zero_()
    else:
        dropped = (~alive).sum().to(torch.int32)
        residue, pairs = K.secagg_residue(*tables, alive, d, count=count)
    recovered, ok = K.secagg_unmask_sum(grads.float().contiguous(), deltas,
                                        residue, alive, ok)
    return recovered, {"secagg_sum_check_ok": ok,
                       "secagg_dropped": dropped,
                       "secagg_masks_reconstructed": pairs,
                       "secagg_recovery": (dropped > 0).to(torch.int32)}


def protect(grads: torch.Tensor, tables, alive=None, ok=None, count=None):
    """One protocol round over the (n, d) f32 matrix ``grads`` with the
    round's device ``tables``: derive the net masks, mask, recover and
    verify (:func:`unmask_sum`).  The ``protect`` stage (utils/costs.py)."""
    with stage_scope("protect"):
        deltas = K.secagg_deltas(*tables, grads.shape[1])
        return unmask_sum(grads, deltas, alive, tables, ok, count)


def secagg_cohort(grads: torch.Tensor, alive: Optional[torch.Tensor],
                  key: np.ndarray, t: int, ids=None):
    """One full protocol round over an (n, d) f32 cohort matrix under
    round t's key: ``ids`` are the global client ids behind the rows
    (default the row indices, the flat round's full participation),
    ``alive`` the quarantine mask (None: everyone submitted).  Returns
    ``(recovered, stats)``; ``recovered`` is bit for bit the clear matrix
    with the dead rows zeroed.  The ``protect`` stage, the tables'
    copy to the device included."""
    n = grads.shape[0]
    ids = np.arange(n) if ids is None else ids
    with stage_scope("protect"):
        tables = round_tables(threefry.fold_in(key, t), ids, grads.device)
        return protect(grads, tables, alive)


def secagg_group(grads: torch.Tensor, key: np.ndarray, t: int, ids,
                 alive: Optional[torch.Tensor] = None):
    """Groupwise mode's per-megabatch round, masks keyed on the group's
    global client ids: ``(recovered, sum_check_ok)`` with everyone
    submitting, ``(recovered, stats)`` with the (m,) dropout mask
    ``alive``, as in the JAX package."""
    recovered, stats = secagg_cohort(grads, alive, key, t, ids=ids)
    if alive is None:
        return recovered, stats["secagg_sum_check_ok"]
    return recovered, stats


def group_envelope_stats(group_means: torch.Tensor, megabatch: int):
    """The envelope the server can still see under groupwise secagg:
    per-group sum norms and cosine to the mean over the (S, d)
    group-estimate matrix (``group_means`` = sums / m, what tier 2
    reduces), the group-level twin of
    defenses/kernels.py:population_telemetry.  The norm spelling,
    ``norm(mean) * m`` with the sum of squares of :func:`row_norms`, is
    the engine's 'secagg' ``group_sum_norms`` bit for bit.  Two (S,) f32
    vectors."""
    E = group_means.float()
    norms = row_norms(E)
    mean = E.mean(0)
    cos = (E @ mean) / (norms * row_norms(mean) + 1e-12)
    return {"group_sum_norms": norms * megabatch,
            "group_cos_to_mean": cos}
