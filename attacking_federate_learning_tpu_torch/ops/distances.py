"""Pairwise Euclidean distances over the client axis.

The reference builds an O(n^2) dict of ``np.linalg.norm(g_i - g_j)`` in a
Python double loop (reference defences.py:16-21).  Here the whole matrix
is one Gram product with the epilogue

    D = sqrt(max(||g_i||^2 + ||g_j||^2 - 2 g_i.g_j, 0)),  zero diagonal,

in f32.  :func:`pairwise_distances` runs the hand-written CUDA kernel
(csrc/pairwise_distances.cu) on a CUDA tensor and the plain PyTorch
version, :func:`pairwise_distances_plain`, on a CPU tensor.  A bf16
matrix takes the kernel's bf16 operand route, the JAX kernel's: a bf16
Gram accumulated in f32, f32 norms, f32 distances.

:func:`gram_plan` cuts the kernel's Gram (csrc/gram_tile.cuh) into tiles
and d into slices for a card with a given SM count; the fused Krum-score
kernel shares it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from attacking_federate_learning_tpu_torch.ops import _build

TILE = 128            # Gram tile edge (gram_tile.cuh: kT)
THREAD_TILE = 8       # thread tile edge (kTT)
THREADS = 256         # stage-1 block (kThreads)
CHAIN = 256           # products per FMA chain (kChainProducts)
RESIDENT = 1          # stage-1 blocks an SM holds at once (launch bounds)
GROUPS = 8            # epilogue runs of partials (kGroups)
# What one partial tile costs the card (its 64 KB written by stage 1 and
# read by stage 2, about 44 ns at 3 TB/s), in units of one chain of one
# tile on one SM (128 * 128 * 256 FMAs at 128 a clock, about 19 us).
PARTIAL_COST = 1 / 400


class GramPlan(NamedTuple):
    """The Gram's split: the ``tiles`` 128 x 128 tiles on or above the
    diagonal, d in ``slices`` slices of ``cps`` chains of 256 products
    (the last slice may hold fewer), and each chunk of 32 k split over
    ``kgroups`` groups of a block's threads where one tile would leave
    half of them idle or more."""

    n: int
    d: int
    tiles: int
    chains: int
    cps: int
    slices: int
    kgroups: int

    @property
    def workspace_bytes(self) -> int:
        """Bytes of the partial tiles, (slices, tiles, 128, 128) f32, and
        of their diagonals, (slices, nt * 128) f32."""
        nt = -(-self.n // TILE)
        return 4 * self.slices * (self.tiles * TILE * TILE + nt * TILE)

    @property
    def run_size(self) -> int:
        """Partials the epilogue sums in order before it adds the runs'
        sums in run order."""
        return -(-self.slices // GROUPS)

    @property
    def rounding_chain(self) -> int:
        """Longest sequential chain of roundings in one Gram output: a k
        group's FMA chain (its share of 256 products), the other groups'
        chains added to it, the slice's other chains, the other partials
        of its epilogue run, then the other runs' sums."""
        runs = -(-self.slices // self.run_size)
        return (CHAIN // self.kgroups + (self.kgroups - 1) + (self.cps - 1)
                + (self.run_size - 1) + (runs - 1))


@functools.lru_cache(maxsize=256)
def gram_plan(n: int, d: int, sms: int) -> GramPlan:
    """The split of the (n, d) Gram for a card with ``sms`` SMs.

    tiles x slices must give every SM a block wherever the chains allow
    it.  Among such splits, the one with the least estimated time: the
    chains the busiest SM runs, counting ``RESIDENT`` blocks to an SM in a
    wave, plus the traffic of the partial tiles (ties: fewer slices)."""
    if n < 1 or d < 1 or sms < 1:
        raise ValueError(f"gram_plan needs n, d, sms >= 1, got {n}, {d}, "
                         f"{sms}")
    nt = -(-n // TILE)
    tiles = nt * (nt + 1) // 2
    chains = -(-d // CHAIN)
    want = min(chains, -(-sms // tiles))
    best = None
    for cps in range(1, chains + 1):
        slices = -(-chains // cps)
        if slices < want:
            break
        cost = (-(-tiles * slices // (RESIDENT * sms)) * cps
                + PARTIAL_COST * tiles * slices)
        if best is None or (cost, slices) < best[:2]:
            best = (cost, slices, cps)
    kgroups = 1
    if nt == 1:
        mr = -(-n // THREAD_TILE)
        live = mr * (mr + 1) // 2          # thread tiles of the one tile
        if live <= THREADS // 4:
            kgroups = 4
        elif live <= THREADS // 2:
            kgroups = 2
    return GramPlan(n, d, tiles, chains, best[2], best[1], kgroups)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def device_gram_plan(G: torch.Tensor) -> GramPlan:
    """The plan for G on its card."""
    n, d = G.shape
    return gram_plan(n, d, _sm_count(G.device.index
                                     if G.device.index is not None
                                     else torch.cuda.current_device()))


def gram_workspace(G: torch.Tensor, plan: GramPlan) -> torch.Tensor:
    return torch.empty(plan.workspace_bytes // 4, dtype=torch.float32,
                       device=G.device)


def pairwise_distances_plain(G: torch.Tensor) -> torch.Tensor:
    """(n, d) -> (n, n) distances, zero diagonal: the kernel's function in
    plain PyTorch (the JAX package's ops/distances.py).  The Gram runs in
    full f32 as long as TF32 matmul is off (PyTorch's default); a bf16
    matrix is widened to f32 first, which is exact."""
    G = G.float()
    sq = (G * G).sum(1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (G @ G.T)
    D = torch.sqrt(torch.clamp(d2, min=0.0))
    D.fill_diagonal_(0.0)
    return D


def gram_route(name: str, G: torch.Tensor) -> str:
    """The kernel of ``name`` that takes G: its bf16 route for bf16."""
    return f"{name}[bf16]" if G.dtype == torch.bfloat16 else name


def pairwise_distances(G: torch.Tensor) -> torch.Tensor:
    """(n, d) f32 or bf16 -> (n, n) f32 distances with an exact zero
    diagonal."""
    if G.device.type == "cpu":
        return pairwise_distances_plain(G)
    name = gram_route("pairwise_distances", G)
    _build.check_cuda_matrix(G, name)
    n, d = G.shape
    fn = _build.entry_point(name)
    plan = device_gram_plan(G)
    ws = gram_workspace(G, plan)
    D = torch.empty((n, n), dtype=torch.float32, device=G.device)
    status = fn(G.data_ptr(), n, d, plan.slices, plan.cps, plan.kgroups,
                ws.data_ptr(), D.data_ptr(), _build.stream_handle(G))
    _build.check_status(name, status)
    _build.LAUNCHES[name] += 1
    return D
