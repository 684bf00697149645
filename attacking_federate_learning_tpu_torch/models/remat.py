"""A recomputing checkpoint that runs under the client step's
``vmap(grad(...))``: the port's counterpart of ``jax.checkpoint``.

``torch.utils.checkpoint`` keeps its recompute in saved-tensor hooks,
which ``torch.func``'s transforms refuse, so it cannot run inside the
client step (tests/test_torch_port_models.py pins that).  :class:`Remat`
is an ``autograd.Function`` instead, which ``torch.func`` does support:
its forward runs the unit without building a graph and saves only the
unit's input and parameters; its backward runs the unit again through
``torch.func.vjp`` and returns the cotangents of the input and of every
parameter.  ``generate_vmap_rule`` lets ``vmap`` batch both over the
clients.  The recompute repeats the forward's calls on the same tensors,
so a gradient with the checkpoint is the gradient without it, bit for
bit, where the device's kernels are deterministic.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call, vjp


class Remat(torch.autograd.Function):
    """``Remat.apply(module, names, x, *params)`` is
    ``functional_call(module, dict(zip(names, params)), (x,))``, with the
    unit's activations recomputed in the backward instead of saved."""

    generate_vmap_rule = True

    @staticmethod
    def forward(module, names, x, *params):
        with torch.no_grad():
            return functional_call(module, dict(zip(names, params)), (x,))

    @staticmethod
    def setup_context(ctx, inputs, output):
        module, names, x, *params = inputs
        ctx.module, ctx.names = module, names
        ctx.save_for_backward(x, *params)

    @staticmethod
    def backward(ctx, cotangent):
        x, *params = ctx.saved_tensors

        def unit(x, *params):
            return functional_call(ctx.module,
                                   dict(zip(ctx.names, params)), (x,))

        # torch.func.grad runs the backward with create_graph=True, so the
        # recompute would be recorded for a second derivative and its
        # activations kept until the whole step ends, every unit's at
        # once.  Under no_grad only vjp's own level records them, and they
        # go when this unit's cotangents are out.
        with torch.no_grad():
            _, pullback = vjp(unit, x, *params)
            return (None, None) + tuple(pullback(cotangent))


def remat_call(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``module(x)`` under :class:`Remat`, on the parameters the module
    holds now: inside ``functional_call`` those are the tensors it
    swapped in, so the gradient flows on to the flat weights."""
    names, params = zip(*module.named_parameters())
    return Remat.apply(module, names, x, *params)
