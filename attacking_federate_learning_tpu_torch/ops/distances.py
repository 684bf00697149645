"""Pairwise Euclidean distances over the client axis.

The reference builds an O(n^2) dict of ``np.linalg.norm(g_i - g_j)`` in a
Python double loop (reference defences.py:16-21).  Here the whole matrix
is one Gram product with the epilogue

    D = sqrt(max(||g_i||^2 + ||g_j||^2 - 2 g_i.g_j, 0)),  zero diagonal,

in f32.  :func:`pairwise_distances` runs the hand-written CUDA kernel
(csrc/pairwise_distances.cu) on a CUDA tensor and the plain PyTorch
version, :func:`pairwise_distances_plain`, on a CPU tensor.
"""

from __future__ import annotations

import torch

from attacking_federate_learning_tpu_torch.ops import _build


def pairwise_distances_plain(G: torch.Tensor) -> torch.Tensor:
    """(n, d) -> (n, n) distances, zero diagonal: the kernel's function in
    plain PyTorch (the JAX package's ops/distances.py).  The Gram runs in
    full f32 as long as TF32 matmul is off (PyTorch's default)."""
    G = G.float()
    sq = (G * G).sum(1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (G @ G.T)
    D = torch.sqrt(torch.clamp(d2, min=0.0))
    D.fill_diagonal_(0.0)
    return D


def pairwise_distances(G: torch.Tensor) -> torch.Tensor:
    """(n, d) f32 -> (n, n) f32 distances with an exact zero diagonal."""
    if G.device.type == "cpu":
        return pairwise_distances_plain(G)
    name = "pairwise_distances"
    _build.check_cuda_matrix(G, name)
    n, d = G.shape
    fn = _build.entry_point(name)
    sq = torch.empty(n, dtype=torch.float32, device=G.device)
    D = torch.empty((n, n), dtype=torch.float32, device=G.device)
    status = fn(G.data_ptr(), n, d, sq.data_ptr(), D.data_ptr(),
                _build.stream_handle(G))
    _build.check_status(name, status)
    _build.LAUNCHES[name] += 1
    return D
