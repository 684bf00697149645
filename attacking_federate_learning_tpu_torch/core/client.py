"""Batched client computation.

The reference runs N sequential ``User.step`` calls per round, each one
minibatch forward/backward with no local optimizer step (reference
server.py:54-56, user.py:83-92).  Here the whole client population is one
call:

    grads = vmap(grad(loss))(broadcast_weights, client_xs, client_ys)

over stacked per-client batches, giving the (n, d) flat gradient matrix
directly in wire order.  Only the reference's FedSGD regime (one
minibatch gradient per client per round) is in this slice.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.func import functional_call, grad, vmap

from attacking_federate_learning_tpu_torch.models.layers import nll_loss
from attacking_federate_learning_tpu_torch.utils.flatten import FlatParams


def make_loss_fn(model: nn.Module, flat: FlatParams):
    """Mean-NLL loss on flat wire-format weights (reference user.py:36,
    :77-79: log_softmax head + NLLLoss)."""

    def loss_fn(flat_w, x, y):
        return nll_loss(functional_call(model, flat.unflatten(flat_w), (x,)),
                        y)

    return loss_fn


def make_client_grad_fn(model: nn.Module, flat: FlatParams):
    """(d,), (n, B, ...), (n, B) int64 -> (n, d) per-client gradients."""
    clients_grads = vmap(grad(make_loss_fn(model, flat)),
                         in_dims=(None, 0, 0))

    def fn(flat_w: torch.Tensor, xs: torch.Tensor,
           ys: torch.Tensor) -> torch.Tensor:
        return clients_grads(flat_w, xs, ys)

    return fn
