"""Server state and the aggregation update.

The reference server's global state is the flat weight vector and the
momentum velocity (reference server.py:34-36), updated by
``v = mu*v - lr*g; w += v`` on the *constant* base learning rate
(server.py:89-90 — the faded lr reaches only the clients).  The (n, d)
gradient matrix is not part of the state: it flows through the round.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ServerState(NamedTuple):
    weights: torch.Tensor    # (d,) flat wire-format weights
    velocity: torch.Tensor   # (d,) momentum buffer
    round: int


def init_server_state(flat_weights: torch.Tensor) -> ServerState:
    return ServerState(weights=flat_weights,
                       velocity=torch.zeros_like(flat_weights), round=0)


def momentum_update(state: ServerState, agg_grad: torch.Tensor,
                    learning_rate: float, momentum: float) -> ServerState:
    """Momentum-SGD step on the aggregated gradient (reference
    server.py:89-90)."""
    velocity = momentum * state.velocity - learning_rate * agg_grad
    return ServerState(weights=state.weights + velocity, velocity=velocity,
                       round=state.round + 1)


def faded_learning_rate(base_lr: float, fading_rate: float,
                        epoch: int) -> float:
    """Hyperbolic LR fading (reference server.py:50-52)."""
    return base_lr * fading_rate / (epoch + fading_rate)
