"""Baseline Byzantine attacks for grid comparisons.

The reference ships exactly two attacks (ALIE and the clipped backdoor);
these textbook baselines give the defense grid its classical comparison
points.  Same ``craft`` seam as every other attack.
"""

from __future__ import annotations

import torch

from attacking_federate_learning_tpu_torch.attacks.base import (
    Attack, cohort_stats, wire_scalar
)
from attacking_federate_learning_tpu_torch.utils import threefry


class SignFlipAttack(Attack):
    """Submit the negated cohort mean scaled by num_std — classic
    gradient-ascent Byzantine behavior."""

    name = "signflip"

    def craft(self, mal_grads, ctx=None):
        mean, _ = cohort_stats(mal_grads)
        return wire_scalar(-self.num_std, mean) * mean


class GaussianNoiseAttack(Attack):
    """Replace the cohort gradient with pure Gaussian noise at num_std
    times the cohort's per-coordinate std.

    The noise is the JAX package's draw, ``jax.random.normal`` under
    ``fold_in(key(seed), round)``, made on the host (utils/threefry.py)
    and copied to the gradients' device."""

    name = "noise"

    def __init__(self, num_std: float, seed: int = 0):
        super().__init__(num_std)
        self._key = threefry.key(seed)

    def noise(self, rnd: int, d: int,
              dtype=torch.float32) -> torch.Tensor:
        """The round-``rnd`` (d,) noise draw in ``dtype`` (f32 or bf16,
        the wire's: JAX draws it in the mean's dtype), on the host."""
        k = threefry.fold_in(self._key, rnd)
        if dtype == torch.bfloat16:
            return threefry.normal_bf16(k, (d,))
        return torch.from_numpy(threefry.normal(k, (d,)))

    def craft(self, mal_grads, ctx=None):
        mean, stdev = cohort_stats(mal_grads)
        rnd = ctx.round if ctx is not None else 0
        noise = self.noise(rnd, mean.shape[0], mean.dtype).to(mean.device)
        return mean + wire_scalar(self.num_std, stdev) * stdev * noise
