"""Attack framework.

The reference's attack seam is ``Attack.attack(mal_users)`` called once
per round between client compute and gradient collection (reference
main.py:66-68, malicious.py:10-27): it computes the mean and population
std of the malicious cohort's *honest* gradients, asks the subclass for
one crafted vector, and overwrites every malicious client's gradient with
it (malicious.py:26-27).  Malicious clients are the first f ids
(reference main.py:28), so the seam replaces rows [0, f) of the (n, d)
matrix.  ``num_std == 0`` disables crafting (malicious.py:21-22).

``craft(mal_grads, ctx)`` takes an :class:`AttackContext`: what the
reference stashes on user 0 (user.py:84-86), the round's broadcast
weights and the faded learning rate, plus the round index that seeds the
noise attack and, in async rounds, the delivered rows' staleness: there
the seam runs at delivery time, and crafting statistics come from the
delivered malicious rows (:func:`delivered_cohort_stats`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class AttackContext(NamedTuple):
    original_params: torch.Tensor  # (d,) weights broadcast this round
    learning_rate: torch.Tensor    # () f32 faded lr, reference server.py:50
    round: int = 0                 # round index (rng derivation)
    # Async rounds only (core/async_rounds.py): the (m,) int32 staleness
    # of the DELIVERED cohort, t - birth on delivered rows and -1 on the
    # rest.  None under the flat round, where every row is fresh.
    staleness: Optional[torch.Tensor] = None
    # Whether an attack that checks its crafted vector for non-finite
    # values (``checks_finite``) raises in the craft itself.  The
    # hierarchical round sets it False and reduces each megabatch's flag
    # on the device once a round instead.
    check_finite: bool = True


def cohort_stats(mal_grads: torch.Tensor):
    """Mean and population std over the malicious cohort (reference
    malicious.py:18-19: np.var ** 0.5, i.e. ddof=0), in the wire's dtype.
    On a bf16 wire they round where ``jnp.mean``, ``jnp.var`` and
    ``jnp.sqrt`` do: the mean and the variance computed in f32 and
    rounded to bf16 once, the square root of the rounded variance
    rounded again."""
    dtype = mal_grads.dtype
    G = mal_grads.float()
    mean = G.mean(0).to(dtype)
    stdev = torch.sqrt(G.var(0, correction=0).to(dtype))
    return mean, stdev


def masked_cohort_stats(mal_grads: torch.Tensor, delivered: torch.Tensor):
    """Mean and population std over the DELIVERED malicious rows only
    (``delivered`` (f,) bool), with fixed shapes: the sums over the full
    axis divided by the delivered count (at least 1).  With every row
    delivered this is :func:`cohort_stats` up to summation order."""
    e = torch.clamp(delivered.sum(), min=1)
    sel = delivered[:, None]
    mean = torch.where(sel, mal_grads, 0.0).sum(0) / e
    var = torch.where(sel, (mal_grads - mean[None, :]) ** 2, 0.0).sum(0) / e
    return mean, torch.sqrt(var)


def delivered_cohort_stats(mal_grads: torch.Tensor, ctx):
    """The crafting statistics of the attack seam: the full-cohort
    :func:`cohort_stats` in the flat round, the delivered rows' in async
    rounds (``ctx.staleness >= 0`` marks delivery)."""
    if ctx is None or ctx.staleness is None:
        return cohort_stats(mal_grads)
    f = mal_grads.shape[0]
    return masked_cohort_stats(mal_grads, ctx.staleness[:f] >= 0)


def wire_scalar(x: float, like: torch.Tensor) -> float:
    """``x`` rounded to ``like``'s dtype, as jnp rounds a Python scalar to
    a bf16 array's dtype before the op; torch would keep it in f32 for a
    bf16 op.  On an f32 wire it is x in f32, what torch uses anyway."""
    return float(torch.tensor(x, dtype=like.dtype))


class Attack:
    """Base class; subclasses implement ``craft``."""

    name = "none"

    def __init__(self, num_std: float):
        self.num_std = num_std

    def craft(self, mal_grads: torch.Tensor,
              ctx: Optional[AttackContext]) -> torch.Tensor:
        """(f, d) honest malicious-cohort grads -> (d,) crafted vector."""
        raise NotImplementedError

    def apply(self, users_grads: torch.Tensor, corrupted_count: int,
              ctx: Optional[AttackContext] = None) -> torch.Tensor:
        """Returns users_grads with the first f rows replaced (in place:
        the round owns the matrix; the crafted row is rounded to its
        dtype).  No-op when f == 0 (reference malicious.py:11) or num_std
        == 0 (malicious.py:21)."""
        f = corrupted_count
        if f == 0 or self.num_std == 0:
            return users_grads
        crafted = self.craft(users_grads[:f], ctx)
        users_grads[:f] = crafted[None, :]
        return users_grads

    def envelope_stats(self, users_grads: torch.Tensor,
                       corrupted_count: int,
                       ctx: Optional[AttackContext] = None) -> dict:
        """The telemetry seam (``cfg.telemetry``): fixed-shape device
        stats of the crafting envelope, on the PRE-attack matrix (the
        honest malicious-cohort view ``craft`` derives its statistics
        from); no host read.  Default: nothing to report."""
        return {}

    def margin_stats(self, users_grads: torch.Tensor, corrupted_count: int,
                     ctx: Optional[AttackContext] = None,
                     crafted: Optional[torch.Tensor] = None) -> dict:
        """The margin seam (``cfg.margins``): fixed-shape device stats of
        how much of the defense-evading envelope the attack spends.
        ``users_grads`` is the PRE-attack matrix, ``crafted`` the
        POST-attack one (for stats of the delivered rows); no host read.
        Default: nothing to report."""
        return {}


class NoAttack(Attack):
    name = "none"

    def __init__(self):
        super().__init__(num_std=0.0)

    def apply(self, users_grads, corrupted_count, ctx=None):
        return users_grads
