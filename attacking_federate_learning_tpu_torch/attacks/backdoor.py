"""Clipped backdoor attack.

Reproduces the reference ``BackdoorAttack`` pipeline (reference
backdoor.py:13-159) as the JAX package restructures it
(attacks/backdoor.py there):

1. Project where honest descent would land this round:
   ``start = original_params - faded_lr * grads_mean`` (backdoor.py:54).
2. Fine-tune a shadow net from ``start`` on poisoned data — trigger pattern
   with target class 0, or a single sample relabeled (y+1)%5
   (backdoor.py:80-83, :128-131) — with the anchor loss
   ``NLL + alpha * sum_tensors MSE(p, p_start)`` (backdoor.py:140-148),
   skipping training entirely when the backdoor already classifies at 100%
   (backdoor.py:114-116).
3. Re-express the desired parameters as a gradient:
   ``new_grads = (start - (mal_params + lr*mean)) / lr`` (backdoor.py:59-60).
4. Launder it through the ALIE envelope: clip into
   ``[mean - z*sigma, mean + z*sigma]`` (backdoor.py:62-63) — the clipping is
   what defeats the statistical defenses.

Reference quirks preserved: the shadow optimizer is constructed fresh every
batch (backdoor.py:132), making its momentum inert — the effective update is
plain SGD with lr 0.1 and weight decay 1e-4 on every tensor, biases
included; a non-finite crafted vector raises (backdoor.py:145-152), here in
the craft seam before anything is aggregated, so the server state stays at
the last finished round.

Shadow training is ``torch.func.grad`` over ``functional_call`` on views
of a flat weight vector: the server model's parameters are never touched.
Its matmuls run in IEEE fp32 on the card: PyTorch's default
``torch.backends.cuda.matmul.allow_tf32 = False`` is what the port relies
on (chip_smoke.py sets it explicitly).  Every division by the learning
rate or the poison count divides by a 0-d device tensor, which is an
IEEE division on the card (a Python scalar divisor there becomes a
multiplication by its reciprocal).

Deviation (the JAX package's, documented there): reference 'sample k' mode
indexes a shuffled permutation via DistributedSampler rank k-1
(backdoor.py:33-34) and is broken from the CLI (argparse leaves k a
string); here 'sample k' poisons training image k-1 directly.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import functional_call, grad

from attacking_federate_learning_tpu_torch.attacks.base import (
    Attack, delivered_cohort_stats, wire_scalar
)
from attacking_federate_learning_tpu_torch.core.engine import resolve_device
from attacking_federate_learning_tpu_torch.core.evaluate import (
    masked_nll_metrics, pad_to_batches
)
from attacking_federate_learning_tpu_torch.data import triggers
from attacking_federate_learning_tpu_torch.models.base import get_model
from attacking_federate_learning_tpu_torch.utils.flatten import FlatParams
from attacking_federate_learning_tpu_torch.utils.numerics import row_norms


class BackdoorAttack(Attack):
    name = "backdoor"
    # The crafted vector is checked for non-finite values: in the craft
    # (ctx.check_finite), or by the hierarchical round's per-megabatch
    # flags.
    checks_finite = True

    def __init__(self, cfg, dataset, device="cuda"):
        super().__init__(cfg.num_std)
        self.cfg = cfg
        self.backdoor = cfg.backdoor
        self.alpha = cfg.alpha
        self.device = resolve_device(device)
        # The module gives the shapes and the forward; the weights come
        # from the flat vector on every call.
        self.model = get_model(cfg.model, torch.Generator().manual_seed(
            cfg.seed)).to(self.device)
        self.flat = FlatParams(self.model)
        self._build_poison_set(dataset, np.random.default_rng(cfg.seed))
        self._grad = grad(self._shadow_loss)
        self.early_outs = 0   # rounds whose shadow training was skipped

    def _build_poison_set(self, dataset, rng):
        B = self.cfg.mal_batch_size
        x, y = dataset.train_x, dataset.train_y
        if self.backdoor == "pattern":
            # A random 1/u strided shard, u = len/batch/10 (reference
            # backdoor.py:37-42) — about 10 batches of mal_batch_size.
            # The JAX package's numpy call order: permutation, integers.
            u = max(1, len(x) // B // 10)
            perm = rng.permutation(len(x))
            shard = perm[int(rng.integers(u))::u]
            px = triggers.add_pattern(torch.from_numpy(x[shard]))
            py = torch.from_numpy(y[shard])
        else:
            # 'sample k': the single training image k-1.
            k = int(self.backdoor) - 1
            px = torch.from_numpy(x[k: k + 1])
            py = torch.from_numpy(y[k: k + 1])
        py = triggers.backdoor_targets(py, self.backdoor)

        # Pad to whole batches with a validity mask (the eval path's
        # helper).
        n = px.shape[0]
        bx, by, bm = pad_to_batches(px.numpy(), py.numpy(), min(B, n))
        self.poison_x = torch.from_numpy(bx).to(self.device)
        self.poison_y = torch.from_numpy(by).to(self.device, torch.int64)
        self.poison_mask = torch.from_numpy(bm).to(self.device)
        # A float, as in the JAX package (it prints as "n.0" in the ASR
        # line); _count divides on the device.
        self.poison_count = float(n)
        self._count = torch.tensor(self.poison_count, dtype=torch.float32,
                                   device=self.device)

    def poison_metrics(self, flat_w: torch.Tensor):
        """(loss, correct) over the poisoned set (reference
        backdoor.py:67-102; the loss is the sum of per-batch mean NLLs
        divided by the set size, backdoor.py:89, :93)."""
        loss_sum, correct = masked_nll_metrics(
            self.model, self.flat, flat_w, self.poison_x, self.poison_y,
            self.poison_mask)
        return loss_sum / self._count, correct

    def _shadow_loss(self, w, anchor, x, y, m):
        params = self.flat.unflatten(w)
        logp = functional_call(self.model, params, (x,))
        per_ex = -logp.gather(1, y[:, None]).squeeze(1)
        cls = (per_ex * m).sum() / torch.clamp(m.sum(), min=1.0)
        # Anchor: sum over parameter tensors of per-tensor mean MSE
        # (torch MSELoss summed across parameters, backdoor.py:142-144),
        # in wire order as the JAX package sums its leaves.
        dist = sum(torch.mean((p - a) ** 2) for p, a in
                   zip(params.values(), self.flat.unflatten(anchor).values()))
        return cls + self.alpha * dist

    def train_shadow(self, start: torch.Tensor) -> torch.Tensor:
        """``mal_epochs`` passes of plain SGD with weight decay over the
        poison batches in order, from and anchored at ``start``; ``start``
        itself when the backdoor already fires on every poisoned example
        (one host read)."""
        _, correct = self.poison_metrics(start)
        if bool(100.0 * correct / self._count >= 100.0):
            self.early_outs += 1
            return start
        cfg = self.cfg
        lr, wd = cfg.mal_learning_rate, cfg.mal_weight_decay
        nb = self.poison_x.shape[0]
        w = start
        for i in range(cfg.mal_epochs * nb):
            b = i % nb
            g = self._grad(w, start, self.poison_x[b], self.poison_y[b],
                           self.poison_mask[b])
            # Fresh-optimizer-per-batch quirk: the momentum buffer is
            # always zero (reference backdoor.py:132).
            w = w - lr * (g + wd * w)
        return w

    def craft(self, mal_grads, ctx):
        # Async rounds (ctx.staleness set): the clip envelope and the
        # descent projection come from the DELIVERED malicious rows only;
        # the server never aggregates the rest.
        mean, stdev = delivered_cohort_stats(mal_grads, ctx)
        # The clip bounds stay in the wire's dtype (jnp's bf16 ops); the
        # shadow arithmetic is f32, as the f32 weights and lr promote a
        # bf16 mean in JAX (torch keeps a 0-d tensor's type out of it).
        z = wire_scalar(self.num_std, stdev)
        lo = mean - z * stdev
        hi = mean + z * stdev
        mean = mean.float()
        lr = ctx.learning_rate
        # The JAX package's operation order; folding it into
        # (start - mal_params)/lr - mean would round differently.
        start = ctx.original_params - lr * mean
        mal_params = self.train_shadow(start)
        new_params = mal_params + lr * mean
        new_grads = (start - new_params) / lr
        out = torch.clamp(new_grads, lo.float(), hi.float())
        if ctx.check_finite and not bool(torch.isfinite(out).all()):
            raise FloatingPointError("Got nan in backdoor shadow training")
        return out

    def envelope_stats(self, users_grads, corrupted_count, ctx=None):
        """The ALIE clip envelope the crafted gradient is laundered
        through (its ||z sigma|| halfwidth) and the shadow objective's
        state: the poisoned set's loss and accuracy under the round's
        global weights."""
        f = corrupted_count
        if f == 0 or self.num_std == 0:
            return {}
        _, stdev = delivered_cohort_stats(users_grads[:f], ctx)
        loss, correct = self.poison_metrics(ctx.original_params)
        z = torch.tensor(float(self.num_std), dtype=torch.float32,
                         device=users_grads.device)
        return {"z": z, "clip_halfwidth_norm": z * row_norms(stdev),
                "shadow_loss": loss,
                "poison_acc": 100.0 * correct / self.poison_count}

    def margin_stats(self, users_grads, corrupted_count, ctx=None,
                     crafted=None):
        """Boost headroom: how hard the crafted rows press against the
        clip envelope they were laundered through, measured on the
        POST-attack rows against the PRE-attack envelope (no shadow
        training again).  ``clip_saturation``: the fraction of malicious
        coordinates at a clip edge; ``boost_headroom``: the mean distance
        to the nearer edge over the halfwidth (0 at the edge, 1 at the
        honest mean)."""
        f = corrupted_count
        if f == 0 or self.num_std == 0 or crafted is None:
            return {}
        mean, stdev = delivered_cohort_stats(users_grads[:f], ctx)
        # An f32 z promotes a bf16 wire's envelope to f32, as in JAX.
        half = float(np.float32(self.num_std)) * stdev.float()
        lo, hi = mean.float() - half, mean.float() + half
        rows = crafted[:f].float()
        sat = ((rows <= lo[None, :]) | (rows >= hi[None, :])).float().mean()
        head = torch.minimum(hi[None, :] - rows, rows - lo[None, :])
        return {"clip_saturation": sat,
                "boost_headroom": (head / torch.clamp(half[None, :],
                                                      min=1e-12)).mean()}

    def test_asr(self, flat_w, log=None, tag="POST"):
        """Attack success rate of the *server* weights on the poisoned set
        (reference main.py:91-95 + backdoor.py:67-102); the line is the
        JAX package's (reference backdoor.py:97-101)."""
        loss, correct = self.poison_metrics(flat_w)
        acc = 100.0 * float(correct) / self.poison_count
        if log is not None:
            log("##Test malicious net: [{}] Average loss: {:.4f}, "
                "Accuracy: {}/{} ({:.2f}%)".format(
                    tag, float(loss), int(correct), self.poison_count, acc))
        return acc


class TimedBackdoorAttack(BackdoorAttack):
    """The async timing-channel backdoor: the same crafting pipeline, but
    the attacker games the arrival schedule: its rows always emit with
    delay 0 (``timed``, read by core/async_rounds.py:draw_delays), so
    every delivered malicious row is fresh (full staleness weight), at
    the price of FIFO priority (the freshest-born rows board the k-bus
    last).  The attacker controls content and emission time only;
    arrival timestamps, hence weights, are the server's.

    Only meaningful under ``aggregation='async'``; the engine and the CLI
    refuse it elsewhere."""

    name = "backdoor_timed"
    timed = True
