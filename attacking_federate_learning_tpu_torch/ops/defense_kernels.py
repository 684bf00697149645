"""The defense kernels: fused Krum scores and the trimmed mean.

:func:`krum_scores` — fused distance -> Krum score (csrc/krum_scores.cu):
each row's score sums its k smallest distances to the other rows, through
the complement identity rowsum - (sum of the c = f - 1 (+2 paper) largest),
in one sweep that never writes the (n, n) matrix.  It returns the rowsums
too, for the caller's cancellation guard (defenses/kernels.py).

:func:`trimmed_mean_of` — median-anchored trimmed mean per coordinate
(csrc/trimmed_mean.cu): subtract the median, keep the k values of
smallest magnitude in stable order, return their mean plus the median.

Each runs its CUDA kernel on a CUDA tensor and its plain PyTorch version
(``*_plain``, beside it) on a CPU tensor.
"""

from __future__ import annotations

import torch

from attacking_federate_learning_tpu_torch.ops import _build
from attacking_federate_learning_tpu_torch.ops.distances import (
    pairwise_distances_plain
)


def krum_complement(n: int, corrupted_count: int,
                    paper_scoring: bool = False) -> int:
    """c: how many of a row's n - 1 distances the score drops — f - 1, or
    f + 1 under paper scoring (k = n - f (- 2) kept)."""
    comp = corrupted_count - 1 + (2 if paper_scoring else 0)
    if not 0 <= comp <= max(n - 1, 0):
        raise ValueError(
            f"fused Krum scores need 0 <= f-1(+2) <= n-1 entries per row "
            f"(n={n}, f={corrupted_count}, paper_scoring={paper_scoring})")
    return comp


def krum_scores_plain(G: torch.Tensor, corrupted_count: int,
                      paper_scoring: bool = False):
    """(n, d) -> ((n,) scores, (n,) rowsums) in plain PyTorch: the JAX
    package's ``_krum_scores(method='topk')`` arithmetic without its
    guard (rowsum minus the c largest off-diagonal distances)."""
    n = G.shape[0]
    comp = krum_complement(n, corrupted_count, paper_scoring)
    D = pairwise_distances_plain(G)
    off = ~torch.eye(n, dtype=torch.bool, device=G.device)
    rowsum = torch.where(off, D, 0.0).sum(1)
    if comp == 0:
        return rowsum.clone(), rowsum
    top = torch.topk(torch.where(off, D, -torch.inf), comp, dim=1).values
    return rowsum - torch.clamp(top, min=0.0).sum(1), rowsum


def krum_scores(G: torch.Tensor, corrupted_count: int,
                paper_scoring: bool = False):
    """(n, d) f32 -> ((n,) scores, (n,) rowsums), f32."""
    if G.device.type == "cpu":
        return krum_scores_plain(G, corrupted_count, paper_scoring)
    name = "krum_scores"
    _build.check_cuda_matrix(G, name)
    n, d = G.shape
    comp = krum_complement(n, corrupted_count, paper_scoring)
    fn = _build.entry_point(name)
    sq = torch.empty(n, dtype=torch.float32, device=G.device)
    scores = torch.empty(n, dtype=torch.float32, device=G.device)
    rowsums = torch.empty(n, dtype=torch.float32, device=G.device)
    status = fn(G.data_ptr(), n, d, comp, sq.data_ptr(), scores.data_ptr(),
                rowsums.data_ptr(), _build.stream_handle(G))
    _build.check_status(name, status)
    _build.LAUNCHES[name] += 1
    return scores, rowsums


def trimmed_mean_of_plain(G: torch.Tensor,
                          number_to_consider: int) -> torch.Tensor:
    """(n, d) -> (d,) in plain PyTorch, the JAX package's
    ``defenses/kernels.py:trimmed_mean_of``: jnp.median's midpoint median
    ((lo + hi) * 0.5 of the middle order statistics — not
    ``torch.median``, which returns the lower one), a stable argsort of
    |G - med| along the client axis, and the mean of the first k
    deviations plus the median."""
    n = G.shape[0]
    srt = torch.sort(G, dim=0).values
    med = (srt[(n - 1) // 2] + srt[n // 2]) * 0.5
    dev = G - med[None, :]
    order = torch.sort(dev.abs(), dim=0, stable=True).indices
    kept = dev.gather(0, order[:number_to_consider])
    return kept.mean(0) + med


def trimmed_mean_of(G: torch.Tensor, number_to_consider: int) -> torch.Tensor:
    """(n, d) f32, k static -> (d,) f32 median-anchored trimmed mean."""
    n = G.shape[0]
    k = int(number_to_consider)
    if not 1 <= k <= n:
        raise ValueError(f"trimmed mean keeps 1 <= k <= n values, got "
                         f"k={k}, n={n}")
    if G.device.type == "cpu":
        return trimmed_mean_of_plain(G, k)
    name = "trimmed_mean"
    _build.check_cuda_matrix(G, name)
    d = G.shape[1]
    fn = _build.entry_point(name)
    out = torch.empty(d, dtype=torch.float32, device=G.device)
    status = fn(G.data_ptr(), n, d, k, out.data_ptr(),
                _build.stream_handle(G))
    _build.check_status(name, status)
    _build.LAUNCHES[name] += 1
    return out
