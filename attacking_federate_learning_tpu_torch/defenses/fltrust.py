"""FLTrust-style validation-data defense (Cao et al., NDSS'21), the JAX
package's ``defenses/fltrust.py``: the server computes its own gradient
g0 on the trusted metadata pool (the reference's unconsumed metadata
hook, server.py:62-77), scores each client gradient by its clipped
cosine to g0, ``ts_i = relu(cos(g_i, g0))``, rescales every client
gradient to ||g0|| and returns the trust-weighted average.

The engine hands ``server_grad`` in when the defense carries
``needs_server_grad = True`` (core/engine.py).

The JAX function does not cast ``users_grads``, so on a bf16 wire its
dtypes are JAX's promotions, reproduced here step by step:

- ``gi_norm`` is a bf16 norm: ``sqrt(sum(x * x))`` with JAX's f32 sum
  of a bf16 product, which XLA computes with the product itself in f32
  (its allowed excess precision: the bf16 rounding of the squares is
  dropped), then the sum rounded to bf16 and its square root rounded to
  bf16;
- ``users_grads @ g0`` promotes the wire to f32 (exact) against the f32
  server gradient;
- ``gi_norm * g0_norm`` and ``g0_norm / (gi_norm + eps)`` are f32 over
  bf16 operands, the denominator's ``+ eps`` rounded to bf16 first;
- the rescaled rows and the average are f32.

On an f32 wire every step is f32.  Plain tensor code, as it is plain XLA
in the JAX package.
"""

from __future__ import annotations

import torch

from attacking_federate_learning_tpu_torch.defenses.kernels import DEFENSES


def row_norms(x: torch.Tensor, dim=None) -> torch.Tensor:
    """``jnp.linalg.norm(x, axis=dim)`` as XLA computes it, in x's dtype:
    the squares and their sum in f32, the sum rounded to x's dtype, then
    its square root (rounded to x's dtype)."""
    w = x.float()
    s = (w * w).sum() if dim is None else (w * w).sum(dim)
    return torch.sqrt(s.to(x.dtype))


def trust_scores(users_grads, server_grad, telemetry=False):
    """((n,) f32 trust weights ``relu(cos(g_i, g0))``, (n,) f32 rescale
    factors ``||g0|| / (||g_i|| + eps)``), with JAX's dtypes; with
    ``telemetry`` a third item, ``{'trust_scores', 'cosine',
    'server_grad_norm'}``."""
    g0_norm = row_norms(server_grad)
    gi_norm = row_norms(users_grads, 1)
    eps = 1e-12
    cos = (users_grads.float() @ server_grad) / (
        gi_norm.float() * g0_norm + eps)
    ts = torch.clamp(cos, min=0.0)                      # relu-clipped trust
    rescale = g0_norm / (gi_norm + eps).float()
    if not telemetry:
        return ts, rescale
    return ts, rescale, {"trust_scores": ts, "cosine": cos,
                         "server_grad_norm": g0_norm}


def fltrust(users_grads, users_count, corrupted_count, server_grad=None,
            telemetry=False):
    """``telemetry=True`` also returns ``trust_scores`` (n,) (the
    relu-clipped trust the average used), ``cosine`` (n,) (the raw cosine
    to the server gradient) and ``server_grad_norm`` ()."""
    if server_grad is None:
        raise ValueError("FLTrust requires the server gradient")
    ts, rescale, *diag = trust_scores(users_grads, server_grad, telemetry)
    scaled = users_grads.float() * rescale[:, None]
    agg = (ts @ scaled) / (ts.sum() + 1e-12)
    return (agg, diag[0]) if telemetry else agg


fltrust.needs_server_grad = True
DEFENSES["FLTrust"] = fltrust
