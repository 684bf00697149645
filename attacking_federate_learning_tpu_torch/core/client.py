"""Batched client computation.

The reference runs N sequential ``User.step`` calls per round, each one
minibatch forward/backward with no local optimizer step (reference
server.py:54-56, user.py:83-92).  Here the whole client population is one
call:

    grads = vmap(grad(loss))(broadcast_weights, client_xs, client_ys)

over stacked per-client batches, giving the (n, d) flat gradient matrix
directly in wire order.  :func:`make_client_update_fn` adds the JAX
package's FedAvg-style local steps on top (beyond-reference).
"""

from __future__ import annotations

import inspect

import torch
from torch import nn
from torch.func import functional_call, grad, vmap

from attacking_federate_learning_tpu_torch.models.layers import nll_loss
from attacking_federate_learning_tpu_torch.models.remat import Remat
from attacking_federate_learning_tpu_torch.utils.flatten import FlatParams


def make_loss_fn(model: nn.Module, flat: FlatParams, remat: bool = False):
    """Mean-NLL loss on flat wire-format weights (reference user.py:36,
    :77-79: log_softmax head + NLLLoss).

    ``remat=True`` recomputes activations in the backward instead of
    saving them (models/remat.py), the JAX package's ``jax.checkpoint``
    of the loss: HBM traded for one more forward, for big models or big
    client cohorts, where the vmapped (n, B, activations) footprint
    dominates memory.  A model whose forward takes ``remat`` (the
    ResNets) recomputes one residual block at a time: a checkpoint of
    the whole net would recompute every block's activations at once in
    the backward, and in eager PyTorch the peak would stay where it was.
    Any other model is one unit, its whole forward, as JAX checkpoints
    the whole loss; the NLL of its (B, classes) log-probs stays outside.
    """
    per_block = remat and "remat" in inspect.signature(
        model.forward).parameters

    def loss_fn(flat_w, x, y):
        params = flat.unflatten(flat_w)
        if per_block:
            out = functional_call(model, params, (x,), {"remat": True})
        elif remat:
            out = Remat.apply(model, tuple(params), x, *params.values())
        else:
            out = functional_call(model, params, (x,))
        return nll_loss(out, y)

    return loss_fn


def make_client_grad_fn(model: nn.Module, flat: FlatParams,
                        remat: bool = False):
    """(d,), (n, B, ...), (n, B) int64 -> (n, d) per-client gradients."""
    clients_grads = vmap(grad(make_loss_fn(model, flat, remat)),
                         in_dims=(None, 0, 0))

    def fn(flat_w: torch.Tensor, xs: torch.Tensor,
           ys: torch.Tensor) -> torch.Tensor:
        return clients_grads(flat_w, xs, ys)

    return fn


def make_client_update_fn(model: nn.Module, flat: FlatParams,
                          local_steps: int = 1, remat: bool = False):
    """FedAvg-style local training (beyond-reference: the reference is
    strictly FedSGD, user.py:80), the JAX package's
    ``make_client_update_fn``.

    With ``local_steps == 1`` this is :func:`make_client_grad_fn` (the
    learning rates unused).  With k > 1 each client takes k plain SGD
    steps ``w <- w - lr_train * grad(w)`` at the dispatched (faded)
    ``lr_train`` and reports the pseudo-gradient ``(w0 - w_k) /
    lr_report``, ``lr_report`` being the lr the server multiplies back
    in.

    Signature: (d,), (n, k, B, ...), (n, k, B), lr_train, lr_report ->
    (n, d); the lrs are f32 0-d tensors or Python floats.  ``remat``
    checkpoints each step's loss (:func:`make_loss_fn`)."""
    if local_steps == 1:
        base = make_client_grad_fn(model, flat, remat)

        def clients_update(flat_w, xs, ys, lr_train, lr_report):
            return base(flat_w, xs[:, 0], ys[:, 0])

        return clients_update

    grad_fn = grad(make_loss_fn(model, flat, remat))

    def one_client(flat_w, xs, ys, lr_train, lr_report):
        w = flat_w
        for s in range(local_steps):
            w = w - lr_train * grad_fn(w, xs[s], ys[s])
        return (flat_w - w) / lr_report

    return vmap(one_client, in_dims=(None, 0, 0, None, None))
