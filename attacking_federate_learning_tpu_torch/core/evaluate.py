"""Test-set evaluation.

Reproduces the reference metric exactly (reference server.py:92-112): the
reported "average loss" is the *sum of per-batch mean NLLs* divided by the
test-set size — a quirk of ``test_loss += loss.item()`` with
mean-reduction batches (server.py:104-110) — plus the argmax-correct
count.  The test set is padded to a whole number of batches with a
validity mask; masked per-batch means match the reference's short final
batch.  A model with BatchNorm on batch statistics (``batch_stats``)
normalizes each test batch by its own statistics, padding rows included,
as the JAX package's scan over batches does; other models take all
batches in one forward.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from attacking_federate_learning_tpu_torch.utils.flatten import FlatParams


def pad_to_batches(x: np.ndarray, y: np.ndarray, batch_size: int):
    n = x.shape[0]
    n_batches = -(-n // batch_size)
    pad = n_batches * batch_size - n
    mask = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    xp = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
    yp = np.concatenate([y, np.zeros(pad, y.dtype)])
    shape = (n_batches, batch_size)
    return (xp.reshape(shape + x.shape[1:]), yp.reshape(shape),
            mask.reshape(shape))


@torch.no_grad()
def masked_nll_metrics(model: nn.Module, flat: FlatParams,
                       flat_w: torch.Tensor, bx: torch.Tensor,
                       by: torch.Tensor, bm: torch.Tensor):
    """Batched (nb, B, ...) data with its (nb, B) validity mask -> (sum of
    per-batch masked-mean NLLs, masked correct count), two scalar
    tensors: the reference's exact eval arithmetic (server.py:104-110),
    shared by server eval and the backdoor's ASR check
    (backdoor.py:89-94).  All batches go through one forward, or one
    forward each for a model on batch statistics."""
    params = flat.unflatten(flat_w)
    nb, b = by.shape
    if getattr(model, "batch_stats", False):
        logp = torch.stack([functional_call(model, params, (x,))
                            for x in bx])
    else:
        logp = functional_call(model, params,
                               (bx.reshape((nb * b,) + bx.shape[2:]),))
        logp = logp.reshape(nb, b, -1)
    per_ex = -logp.gather(2, by[..., None]).squeeze(2)
    batch_mean = (per_ex * bm).sum(1) / torch.clamp(bm.sum(1), min=1.0)
    correct = ((logp.argmax(2) == by).float() * bm).sum()
    return batch_mean.sum(), correct


def make_eval_fn(model: nn.Module, flat: FlatParams, test_x: np.ndarray,
                 test_y: np.ndarray, batch_size: int, device):
    """Returns (flat_w) -> (test_loss, correct) scalar tensors on the full
    test set, which stays on ``device``."""
    bx, by, bm = pad_to_batches(test_x, test_y, batch_size)
    bx = torch.from_numpy(bx).to(device)
    by = torch.from_numpy(by).to(device, torch.int64)
    bm = torch.from_numpy(bm).to(device)
    n_test = test_x.shape[0]

    def evaluate(flat_w: torch.Tensor):
        loss_sum, correct = masked_nll_metrics(model, flat, flat_w, bx, by,
                                               bm)
        return loss_sum / n_test, correct

    return evaluate
