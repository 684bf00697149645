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

:func:`gram_plan` cuts the f32 route's Gram (csrc/gram_tile.cuh, on the
FMA units) into tiles and d into slices for a card with a given SM count,
and :func:`mma_plan` the bf16 route's (csrc/gram_mma.cuh, on the tensor
cores); the fused Krum-score kernel shares both.

Over the model axis of a mesh (parallel/mesh.py) the two stages run
apart: :func:`gram_partials` on each model position's (n, d_j) column
block, :func:`gram_epilogue` on the positions' partials in position
order (parallel/model_axis.py:split_distances).  Their
plain versions are a block Gram accumulated in f32 and the epilogue of
the summed Gram.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from attacking_federate_learning_tpu_torch.ops import _build
from attacking_federate_learning_tpu_torch.utils.costs import (
    KernelCost, counted_kernel
)

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

# The bf16 route's stage 1 (gram_mma.cuh).
MMA_ROWS = 64               # rows of one wgmma, one warpgroup's
MMA_COLS = (64, 128)        # its columns N: 64 up to n = 64, then 128
MMA_GROUPS = ((16, 4), (32, 2))   # (most n, chains stacked in its rows)
MMA_STEP = 16               # k of one wgmma; a chain is 16 of them
MMA_RAW_STAGES = 4          # raw stages of the copies' ring (kRaw)
MMA_STAGE_K = (64, CHAIN)   # a stage's k unstacked: a power of two
MMA_TAIL = TILE * 128       # shared memory past the ring (kTailBytes)
MMA_ALIGN = 1024            # the ring's alignment (kAlign)
MMA_MAX_SMEM = 232_448      # a block's shared memory on an H100
# The cost model's rates, per SM of an H100 SXM (132 SMs): the dense bf16
# tensor rate, and the SM's share of the device memory rate.
SM_TENSOR_RATE = 989e12 / 132
SM_BYTES_RATE = 3.35e12 / 132
CARD_BYTES_RATE = 3.35e12


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
    def launch_args(self):
        """What the f32 entry points take after (G, n, d)."""
        return self.slices, self.cps, self.kgroups

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


class MmaPlan(NamedTuple):
    """The bf16 route's split: the ``tiles`` 128 x 128 tiles on or above
    the diagonal, d in ``slices`` slices of ``cps`` chains of 256 k (the
    last slice may hold fewer); blocks of ``warpgroups`` warpgroups, each
    running wgmma on 64 rows and ``cols`` columns, with ``groups`` chains
    stacked in the 64 rows where n <= 32; a pipeline stage of ``stage_k``
    k of at most ``live`` rows of G, in ``rows`` swizzled rows (each
    operand's padded to 8, the busiest tile's; 64 for stacked chains)."""

    n: int
    d: int
    tiles: int
    chains: int
    cps: int
    slices: int
    warpgroups: int
    cols: int
    groups: int
    live: int
    rows: int
    stage_k: int

    @property
    def launch_args(self):
        """What the bf16 entry points take after (G, n, d)."""
        return self.slices, self.cps, self.stage_k

    # The epilogue reads the f32 route's layout and sums it the same way.
    workspace_bytes = GramPlan.workspace_bytes
    run_size = GramPlan.run_size

    @property
    def rounding_chain(self) -> int:
        """Longest sequential chain of roundings in one Gram output: a
        chain's 16 wgmma steps (the tensor core rounds each step's sum to
        f32 once), the slice's other chains, the other partials of its
        epilogue run, then the other runs' sums."""
        runs = -(-self.slices // self.run_size)
        return (CHAIN // MMA_STEP + (self.cps - 1) + (self.run_size - 1)
                + (runs - 1))

    @property
    def smem_bytes(self) -> int:
        """A block's dynamic shared memory (gram_mma.cuh: ring_smem)."""
        return _mma_smem(self.live, self.rows, self.stage_k, self.groups)


def _pad8(r: int) -> int:
    return -(-r // 8) * 8


def _mma_smem(live: int, rows: int, stage_k: int, groups: int) -> int:
    """Two swizzled stages of ``rows`` rows of stage_k / groups k, the
    ring of raw stages of ``live`` rows (stage_k / 8 + 1 aligned 16-byte
    words each), the tail and the alignment."""
    return (2 * rows * (stage_k // groups) * 2
            + MMA_RAW_STAGES * live * (stage_k // 8 + 1) * 16
            + MMA_TAIL + MMA_ALIGN)


@functools.lru_cache(maxsize=256)
def mma_plan(n: int, d: int, sms: int) -> MmaPlan:
    """The split of the (n, d) bf16 Gram on the tensor cores for a card
    with ``sms`` SMs.

    Instruction: one warpgroup with N = 64 where n <= 64, else two with
    N = 128; where n <= 16 (32) four (two) chains are stacked as groups
    of 16 (32) rows of the 64, and a stage holds one chain a group (1,024
    or 512 k).  Otherwise a stage takes the largest power of two of k (64
    to 256, one chain) whose two swizzled stages and four raw ones fit a
    block's shared memory: 256 at n = 60, 128 at n = 100, 64 at n =
    1,000; the three raw stages in flight then hold 60 to 110 KB of
    loads.

    Slices: as :func:`gram_plan`, tiles x slices gives every SM a block
    wherever the chains allow it, and among such splits the one with the
    least estimated time wins (ties: fewer slices).  The estimate is in
    seconds on an H100 SXM:

    - a chain of the busiest block takes the larger of its operations,
      2 * 64 * warpgroups * N * 256 / groups at the SM's dense bf16
      tensor rate
      (989 TFLOP/s / 132: 1.12 us for a full 128 x 128 tile), and its
      bytes, 2 * 256 * min(n, 256) at the SM's share of the device
      memory rate (3.35 TB/s / 132: 2.0 us at n = 100, 5.2 us at n >=
      256, where the rows are re-read from L2 at no better rate in this
      model);
    - a slice's partial costs the card its entries written by stage 1
      and read by stage 2, 2 * 4 * 64 * warpgroups * N bytes (a group's
      block where chains are stacked) at 3.35 TB/s (39 ns for a full
      tile);
    - the time is the waves of blocks (one resident to an SM) times cps
      chains, plus every partial.

    Against the f32 route's model a chain costs about 15 times less (1.12
    us against 19 us for a full tile), so a partial weighs 1/29 of a
    chain instead of 1/400, and the plan takes fewer slices: 156 at n =
    100, d = 79,510 (gram_plan: 311)."""
    if n < 1 or d < 1 or sms < 1:
        raise ValueError(f"mma_plan needs n, d, sms >= 1, got {n}, {d}, "
                         f"{sms}")
    nt = -(-n // TILE)
    tiles = nt * (nt + 1) // 2
    chains = -(-d // CHAIN)
    wgs = 1 if n <= MMA_ROWS else 2
    cols = MMA_COLS[wgs - 1]
    groups = next((g for most, g in MMA_GROUPS if n <= most), 1)
    live = n if nt <= 2 else 2 * TILE
    if groups > 1:
        rows, stage_k = MMA_ROWS, groups * CHAIN
    else:
        rows = (_pad8(n) if nt == 1 else
                TILE + _pad8(n - TILE) if nt == 2 else 2 * TILE)
        stage_k = MMA_STAGE_K[0]
        while (stage_k * 2 <= MMA_STAGE_K[1]
               and _mma_smem(live, rows, stage_k * 2, 1) <= MMA_MAX_SMEM):
            stage_k *= 2
    out = MMA_ROWS * wgs * cols // groups ** 2    # a block's partial
    t_chain = max(2 * MMA_ROWS * wgs * cols * CHAIN / groups
                  / SM_TENSOR_RATE,
                  2 * CHAIN * min(n, 2 * TILE) / SM_BYTES_RATE)
    t_partial = 2 * 4 * out / CARD_BYTES_RATE
    want = min(chains, -(-sms // tiles))
    best = None
    for cps in range(1, chains + 1):
        slices = -(-chains // cps)
        if slices < want:
            break
        cost = (-(-tiles * slices // (RESIDENT * sms)) * cps * t_chain
                + tiles * slices * t_partial)
        if best is None or (cost, slices) < best[:2]:
            best = (cost, slices, cps)
    return MmaPlan(n, d, tiles, chains, best[2], best[1], wgs, cols, groups,
                   live, rows, stage_k)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def device_gram_plan(G: torch.Tensor):
    """The plan for G on its card: :func:`mma_plan` for bf16, else
    :func:`gram_plan`."""
    n, d = G.shape
    sms = _sm_count(G.device.index if G.device.index is not None
                    else torch.cuda.current_device())
    plan = mma_plan if G.dtype == torch.bfloat16 else gram_plan
    return plan(n, d, sms)


def gram_workspace(G: torch.Tensor, plan) -> torch.Tensor:
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


def cross_sq_distances(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(m, d), (n, d) -> (m, n) squared Euclidean distances in f32, the
    JAX package's ``cross_sq_distances``: f32 norms and an f32 Gram (IEEE
    f32 as long as TF32 matmul is off, the port's rule), bf16 operands
    widened to f32 first, which is exact (a bf16 Gram accumulated in
    f32).  The blockwise tiles of parallel/distances.py share it, so
    every tile computes what the whole matrix would."""
    A, B = A.float(), B.float()
    sq_a = (A * A).sum(-1)
    sq_b = (B * B).sum(-1)
    d2 = sq_a[:, None] + sq_b[None, :] - 2.0 * (A @ B.T)
    return torch.clamp(d2, min=0.0)


def gram_route(name: str, G: torch.Tensor) -> str:
    """The kernel of ``name`` that takes G: its bf16 route for bf16."""
    return f"{name}[bf16]" if G.dtype == torch.bfloat16 else name


def gram_operations(n: int, d: int) -> int:
    """The distance kernels' operations: the Gram's n (n - 1) d
    multiply-adds above and below the diagonal counted once each, and
    the 2 n d of the norms."""
    return n * (n - 1) * d + 2 * n * d


def pairwise_distances_cost(n: int, d: int, bf16: bool = False) -> KernelCost:
    """Kernel 1's work at (n, d): the Gram's operations (on the tensor
    cores on the bf16 route), G read once and the (n, n) f32 distances
    written once."""
    return KernelCost(gram_operations(n, d),
                      (2 if bf16 else 4) * n * d + 4 * n * n,
                      "bf16" if bf16 else "fp32")


@counted_kernel(lambda G: gram_route("pairwise_distances", G),
                lambda G: pairwise_distances_cost(
                    *G.shape, G.dtype == torch.bfloat16))
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
    status = fn(G.data_ptr(), n, d, *plan.launch_args, ws.data_ptr(),
                D.data_ptr(), _build.stream_handle(G))
    _build.check_status(name, status)
    _build.LAUNCHES[name] += 1
    return D


# --- the two stages apart: the Gram split over d across the model axis ----

class GramPartials(NamedTuple):
    """Stage 1's output for one model position's (n, d_j) column block:
    on the card its workspace, ``slices`` partial tiles and their
    diagonals in gram_tile.cuh's layout; on the CPU the block's (n, n)
    f32 Gram as one slice."""

    ws: torch.Tensor
    n: int
    slices: int


def gram_partials_plain(G: torch.Tensor) -> torch.Tensor:
    """(n, d) -> (n, n) f32: the block's Gram accumulated in f32 (a bf16
    block widened first, which is exact)."""
    G = G.float()
    return G @ G.T


def gram_epilogue_plain(grams) -> torch.Tensor:
    """(n, n) distances from the positions' block Grams: their sum in
    position order, the norms from the summed diagonal (identical rows
    stay exactly 0 apart), an exact zero diagonal."""
    S = grams[0].clone()
    for g in grams[1:]:
        S += g
    sq = torch.diagonal(S)
    d2 = sq[:, None] + sq[None, :] - 2.0 * S
    D = torch.sqrt(torch.clamp(d2, min=0.0))
    D.fill_diagonal_(0.0)
    return D


def gram_partials_cost(n: int, d: int, bf16: bool = False) -> KernelCost:
    """Stage 1's work on an (n, d) block: the Gram's and the norms'
    operations, the block read once and its (n, n) f32 Gram written once
    (what the partials must hold at the least)."""
    return KernelCost(gram_operations(n, d),
                      (2 if bf16 else 4) * n * d + 4 * n * n,
                      "bf16" if bf16 else "fp32")


def gram_epilogue_cost(n: int, m: int) -> KernelCost:
    """What stage 2 must do from the m model positions' (n, n) Grams: an
    add an entry a position and the epilogue's five operations an entry,
    each position's Gram read once and the distances written once.  The
    slices that stage 1's plan leaves in each block are the plan's cost,
    not the function's, so they are not priced here."""
    return KernelCost((m + 5) * n * n, 4 * n * n * (m + 1))


@counted_kernel(lambda G: gram_route("gram_partials", G),
                lambda G: gram_partials_cost(*G.shape,
                                             G.dtype == torch.bfloat16))
def gram_partials(G: torch.Tensor) -> GramPartials:
    """Stage 1 of the distance kernel on one model position's (n, d_j)
    f32 or bf16 column block, on its device."""
    n, d = G.shape
    if G.device.type == "cpu":
        return GramPartials(gram_partials_plain(G), n, 1)
    name = gram_route("gram_partials", G)
    _build.check_cuda_matrix(G, name)
    fn = _build.entry_point(name)
    plan = device_gram_plan(G)
    ws = gram_workspace(G, plan)
    status = fn(G.data_ptr(), n, d, *plan.launch_args, ws.data_ptr(),
                _build.stream_handle(G))
    _build.check_status(name, status)
    _build.LAUNCHES[name] += 1
    return GramPartials(ws, n, plan.slices)


def gathered_workspace(parts, device) -> torch.Tensor:
    """The positions' workspaces laid end to end on ``device`` as stage 2
    reads them: every position's partial tiles in position order, then
    every position's diagonals."""
    n = parts[0].n
    nt = -(-n // TILE)
    tile_el = nt * (nt + 1) // 2 * TILE * TILE
    diag_el = nt * TILE
    total = sum(p.slices for p in parts)
    ws = torch.empty(total * (tile_el + diag_el), dtype=torch.float32,
                     device=device)
    at, dg = 0, total * tile_el
    for p in parts:
        k = p.slices
        ws[at:at + k * tile_el].copy_(p.ws[:k * tile_el])
        ws[dg:dg + k * diag_el].copy_(
            p.ws[k * tile_el:k * (tile_el + diag_el)])
        at += k * tile_el
        dg += k * diag_el
    return ws


@counted_kernel("gram_epilogue",
                lambda parts, device=None: gram_epilogue_cost(
                    parts[0].n, len(parts)))
def gram_epilogue(parts, device=None) -> torch.Tensor:
    """Stage 2 on ``device`` (default: the first part's): the (n, n) f32
    distances, exact zero diagonal, from the :class:`GramPartials` of
    every model position, in position order."""
    dev = parts[0].ws.device if device is None else torch.device(device)
    kinds = {p.ws.device.type for p in parts} | {dev.type}
    if kinds == {"cpu"}:
        return gram_epilogue_plain([p.ws for p in parts])
    if kinds != {"cuda"}:
        raise ValueError(f"gram_epilogue: the partials and the device must "
                         f"all be CUDA or all CPU, got {sorted(kinds)}")
    for p in parts:
        if p.ws.dtype != torch.float32 or not p.ws.is_contiguous():
            raise ValueError(f"gram_epilogue: expected contiguous float32 "
                             f"partials, got {p.ws.dtype} "
                             f"contiguous={p.ws.is_contiguous()}")
    fn = _build.entry_point("gram_epilogue")
    n = parts[0].n
    ws = gathered_workspace(parts, dev)
    D = torch.empty((n, n), dtype=torch.float32, device=dev)
    status = fn(ws.data_ptr(), n, sum(p.slices for p in parts),
                D.data_ptr(), _build.stream_handle(ws))
    _build.check_status("gram_epilogue", status)
    _build.LAUNCHES["gram_epilogue"] += 1
    return D
