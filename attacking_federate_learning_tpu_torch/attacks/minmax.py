"""AGR-agnostic min-max / min-sum attacks (Shejwalkar & Houmansadr,
NDSS'21, "Manipulating the Byzantine").

Beyond-reference additions (the reference ships only ALIE + backdoor):
the crafted gradient is ``mean + gamma * p`` for a perturbation direction
``p``, with gamma pushed as large as possible subject to staying
inside the benign cohort's own spread:

- min-max:  max_i ||crafted - g_i||  <=  max_{i,j} ||g_i - g_j||
- min-sum:  sum_i ||crafted - g_i||^2  <=  max_i sum_j ||g_i - g_j||^2

Both constraints are monotone in gamma, so gamma* is found by a
fixed-trip bisection: 10 doubling steps from gamma = 10, then 25 halving
steps, as in the JAX package.  gamma is a 0-d f32 tensor on the
gradients' device stepped by ``torch.where``, so the loop reads nothing
back to the host.  Directions: the cohort's negative std ('std', the
paper's best performer), -sign(mean) ('sign'), or the negative unit mean
('unit').
"""

from __future__ import annotations

import torch

from attacking_federate_learning_tpu_torch.attacks.base import (
    Attack, cohort_stats
)

_GROW_STEPS = 10
_BISECT_STEPS = 25
_GAMMA_INIT = 10.0


def _direction(mal_grads, kind):
    mean, stdev = cohort_stats(mal_grads)
    if kind == "std":
        p = -stdev
    elif kind == "sign":
        p = -torch.sign(mean)
    else:  # 'unit'
        p = -mean / torch.clamp(torch.linalg.vector_norm(mean), min=1e-12)
    return mean, p


def _bisect_gamma(feasible, like):
    """Largest gamma with feasible(gamma) True, by doubling and then
    bisection over a fixed number of trips; ``like`` gives the device."""
    hi = torch.full((), _GAMMA_INIT, dtype=torch.float32, device=like.device)
    for _ in range(_GROW_STEPS):
        hi = torch.where(feasible(hi), hi * 2.0, hi)
    lo = torch.zeros((), dtype=torch.float32, device=like.device)
    for _ in range(_BISECT_STEPS):
        mid = 0.5 * (lo + hi)
        ok = feasible(mid)
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return lo


class MinMaxAttack(Attack):
    """Crafted gradient's max distance to any cohort member stays within
    the cohort's own max pairwise distance."""

    name = "minmax"

    def __init__(self, num_std=1.5, direction="std"):
        # num_std is unused by the optimization but kept for the uniform
        # Attack signature (z=0 still disables the attack, base.apply).
        super().__init__(num_std)
        self.direction = direction
        self.last_gamma = None   # the latest craft's gamma (0-d tensor)

    def _threshold(self, G):
        sq = torch.sum(G * G, dim=1)
        d2 = sq[:, None] + sq[None, :] - 2.0 * (G @ G.T)
        return torch.max(torch.clamp(d2, min=0.0))     # max pairwise^2

    def _violation(self, crafted, G):
        return torch.max(torch.sum((G - crafted[None, :]) ** 2, dim=1))

    def craft(self, mal_grads, ctx=None):
        G = mal_grads.to(torch.float32)
        mean, p = _direction(G, self.direction)
        budget = self._threshold(G)

        def feasible(gamma):
            return self._violation(mean + gamma * p, G) <= budget

        gamma = _bisect_gamma(feasible, G)
        self.last_gamma = gamma
        return (mean + gamma * p).to(mal_grads.dtype)


class MinSumAttack(MinMaxAttack):
    """Crafted gradient's summed squared distance to the cohort stays
    within the worst cohort member's own sum."""

    name = "minsum"

    def _threshold(self, G):
        sq = torch.sum(G * G, dim=1)
        d2 = sq[:, None] + sq[None, :] - 2.0 * (G @ G.T)
        return torch.max(torch.sum(torch.clamp(d2, min=0.0), dim=1))

    def _violation(self, crafted, G):
        return torch.sum(torch.sum((G - crafted[None, :]) ** 2, dim=1))
