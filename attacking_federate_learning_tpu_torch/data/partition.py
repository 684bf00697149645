"""Client data partitioning.

The reference partitions via ``DistributedSampler(num_replicas=users_count,
rank=user_id)`` (reference user.py:49-54): one global permutation, padded
to a multiple of n by wrapping, then strided by rank.  The partition is an
int32 index matrix ``shards`` of shape (n_clients, shard_len) computed once
per experiment in numpy (byte-identical to the JAX package for a seed); a
round's batch for all clients at once is

    idx = shards[:, (t*B + arange(B)) % shard_len]          # (n, B)

with wrap-around instead of the reference DataLoader's short final batch.
Also a Dirichlet label-skew partitioner for non-IID experiments, and the
'femnist_style' feature shift: IID shards, each client seeing the data
through its own affine transform (:func:`client_style_params`).
"""

from __future__ import annotations

import numpy as np
import torch


def iid_shards(n_examples: int, n_clients: int, seed: int) -> np.ndarray:
    """DistributedSampler-equivalent IID shards: (n_clients, shard_len)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n_examples)
    shard_len = -(-n_examples // n_clients)  # ceil
    total = shard_len * n_clients
    padded = np.concatenate([perm, perm[: total - n_examples]])
    # rank r takes padded[r::n_clients] — the sampler's strided subsample.
    return np.stack([padded[r::n_clients] for r in range(n_clients)]).astype(
        np.int32)


def dirichlet_shards(labels: np.ndarray, n_clients: int, alpha: float,
                     seed: int) -> np.ndarray:
    """Label-skew non-IID shards via per-class Dirichlet allocation, each
    client's indices wrapped to a common length (dense matrix)."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    per_client: list = [[] for _ in range(n_clients)]
    for c in range(n_classes):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        props = rng.dirichlet(np.full(n_clients, alpha))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for client, chunk in enumerate(np.split(idx, cuts)):
            per_client[client].extend(chunk.tolist())
    shard_len = max(1, max(len(s) for s in per_client))
    out = np.empty((n_clients, shard_len), np.int32)
    for i, s in enumerate(per_client):
        if not s:  # degenerate client: give it one wrapped global sample
            s = [int(rng.integers(len(labels)))]
        reps = -(-shard_len // len(s))
        out[i] = np.tile(np.array(s, np.int32), reps)[:shard_len]
    return out


def client_style_params(n_clients: int, strength: float,
                        seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-client affine style parameters of the 'femnist_style'
    partition, the JAX package's draw byte for byte: client i sees
    ``a_i * x + b_i``, a per-writer contrast and brightness, with

        a_i = 1 + strength * u1   (u1 ~ U[-1, 1])
        b_i = strength/2 * u2     (u2 ~ U[-1, 1])

    from numpy's generator on ``SeedSequence([seed, 0xFE30])``; two
    (n_clients,) float32 arrays."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xFE30]))
    a = 1.0 + strength * rng.uniform(-1.0, 1.0, n_clients)
    b = 0.5 * strength * rng.uniform(-1.0, 1.0, n_clients)
    return a.astype(np.float32), b.astype(np.float32)


def make_shards(partition: str, labels: np.ndarray, n_clients: int,
                seed: int, dirichlet_alpha: float = 0.5) -> np.ndarray:
    if partition in ("iid", "femnist_style"):
        # femnist_style shares the IID index assignment: its non-IIDness
        # is the per-client input transform, not which examples a
        # client holds.
        return iid_shards(len(labels), n_clients, seed)
    if partition == "dirichlet":
        return dirichlet_shards(labels, n_clients, dirichlet_alpha, seed)
    raise ValueError(f"Unknown partition {partition!r}")


def round_batch_indices(shards: torch.Tensor, round_idx: int,
                        batch_size: int) -> torch.Tensor:
    """(n_clients, B) gather indices for one round, cycling each shard
    (the reference's infinite ``cycle`` over each client's loader,
    user.py:11-14)."""
    shard_len = shards.shape[1]
    offs = (round_idx * batch_size
            + torch.arange(batch_size, device=shards.device)) % shard_len
    return shards[:, offs]
