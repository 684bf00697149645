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
noise attack.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class AttackContext(NamedTuple):
    original_params: torch.Tensor  # (d,) weights broadcast this round
    learning_rate: torch.Tensor    # () f32 faded lr, reference server.py:50
    round: int = 0                 # round index (rng derivation)


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


class NoAttack(Attack):
    name = "none"

    def __init__(self):
        super().__init__(num_std=0.0)

    def apply(self, users_grads, corrupted_count, ctx=None):
        return users_grads
