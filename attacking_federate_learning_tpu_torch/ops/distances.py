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

Over the model axis of a mesh (parallel/mesh.py) the Gram is split over
d (csrc/gram_split.cuh, parallel/model_axis.py:split_distances):
:func:`gram_partials` leaves each model position's (n, n) f32 Gram of
its (n, d_j) column block on its device, its slices summed on the card
in thread block clusters as :func:`split_plan` lays them out, and
:func:`gram_epilogue` reads the positions' Grams where they lie and sums
them in position order.  Their plain versions are a block Gram
accumulated in f32 and the epilogue of the summed Gram.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

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


# The split route's stage 1 (csrc/gram_split.cuh).
CLUSTERS = (1, 2, 4, 8, 16)   # cluster sizes (16: non-portable)
SPLIT_CHAINS = (256, 128, 64)  # k per chain
# The split plan's model, in seconds, fitted to stage 1 under forced plans
# on an H100 SXM (tools/split_gram_ab.py sweep, NVIDIA H100 80GB HBM3,
# 700 W, at n = 100, d = 39,755): an f32 block runs a chain of c k in
# c / 6.8e10 s per FMA of its live thread tiles (22.8 us for 256 k of
# the 91 at n = 100, 30 % of the 67 TFLOP/s peak) plus CHAIN_END; a
# bf16 block in 1.95 times mma_plan's model (1.96 us for 128 k); each
# wave of clusters BLOCK_START more (the ring's prologue and the cluster
# sum); the tail TAIL_LAUNCH, and each cluster sum that reaches device
# memory TAIL_RUN (written by its cluster, read by the tail: 0.12 us a
# sum at d = 39,755, 132 clusters of 1 against 7 of 16 at 3 chains a
# block, 0.2 at d = 5,460, 43 of 2 against 3 of 16).
SPLIT_F32_RATE = 6.8e10
SPLIT_BF16_SLOWDOWN = 1.95
CHAIN_END = 0.8e-6
BLOCK_START = 6.5e-6
TAIL_LAUNCH = 2.5e-6
TAIL_RUN = 0.16e-6
TILE_BYTES = 4 * TILE * TILE
SPLIT_WAVES = 4         # the most waves of clusters a plan considers


class SplitPlan(NamedTuple):
    """The split route's stage 1 on an (n, d) block: the ``tiles`` 128 x
    128 tiles on or above the diagonal (the f32 route's block with
    ``kgroups`` k groups, or the bf16 route's with the tensor cores'
    ``stage_k``), d in ``chains`` chains of ``chain`` k (the last may be
    short) dealt out over ``slices`` slices of at most ``cps`` chains,
    the slices run in clusters of ``cluster`` blocks whose partial tiles
    are summed on chip; the ``runs`` cluster sums a tile goes to device
    memory, and the tail sums them into the Gram (no tail where runs =
    1)."""

    n: int
    d: int
    bf16: bool
    tiles: int
    chain: int
    chains: int
    cps: int
    slices: int
    cluster: int
    kgroups: int
    stage_k: int

    @property
    def launch_args(self):
        """What the split entry points take after (G, n, d)."""
        return (self.slices, self.chain, self.cluster,
                self.stage_k if self.bf16 else self.kgroups)

    @property
    def runs(self) -> int:
        return self.slices // self.cluster

    @property
    def mid_floats(self) -> int:
        """The cluster sums' scratch, (tiles, runs, 128, 128) f32 where
        runs > 1."""
        return self.tiles * self.runs * TILE * TILE if self.runs > 1 else 0

    @property
    def rounding_chain(self) -> int:
        """Longest sequential chain of roundings in one Gram output: a
        chain (on the f32 route a k group's FMA chain over its share of
        the chain's products, then the other groups' chains; on the bf16
        route its wgmma k16 steps), the slice's other chains, the other
        partials of its cluster, then the other runs' sums."""
        head = (self.chain // MMA_STEP if self.bf16 else
                self.chain // self.kgroups + self.kgroups - 1)
        return head + (self.cps - 1) + (self.cluster - 1) + (self.runs - 1)

    @property
    def smem_bytes(self) -> int:
        """A block's dynamic shared memory: the f32 route's ring and k
        group exchange and the partial tile, or the bf16 route's ring,
        which the partial tile reuses."""
        if self.bf16:
            base = mma_plan(self.n, self.d, 1)
            return max(_mma_smem(base.live, base.rows, self.stage_k,
                                 base.groups), TILE_BYTES + MMA_ALIGN)
        return _f32_smem(self.kgroups) + TILE_BYTES


def _f32_smem(kgroups: int) -> int:
    """The f32 stage 1's ring of three stages of 32 k of two 128-row
    operands, and its k groups' exchange (gram_tile.cuh: stage1_smem)."""
    return 4 * (3 * 2 * TILE * 32
                + (kgroups - 1) * THREAD_TILE ** 2 * (THREADS // kgroups))


def default_cluster_slots(sms: int) -> tuple:
    """Clusters of each size in CLUSTERS a card with ``sms`` SMs holds at
    once, one block an SM, where the card is not asked
    (:func:`cluster_slots` asks it)."""
    return tuple(sms // c for c in CLUSTERS)


@functools.lru_cache(maxsize=256)
def split_plan(n: int, d: int, sms: int, bf16: bool = False,
               slots: Optional[tuple] = None) -> SplitPlan:
    """The split route's stage 1 on an (n, d) block for a card with
    ``sms`` SMs that holds ``slots[i]`` clusters of ``CLUSTERS[i]`` blocks
    at once (default :func:`default_cluster_slots`).

    The block's instruction shape is the fused route's: the f32 route's
    k groups (:func:`gram_plan`), the bf16 route's warpgroups and stage
    (:func:`mma_plan`).  Among chains of 256, 128 or 64 k (a whole number
    of the bf16 route's stages; 256 where its chains are stacked),
    clusters of 1 to 16 and S = cluster x runs slices, S no more than the
    chains (no slice is empty) and at most SPLIT_WAVES waves of clusters,
    the one with the least estimated time wins (ties: fewer slices, then
    longer chains).  The estimate, in seconds on an H100 SXM: each wave
    of clusters (``tiles`` x runs clusters, ``slots`` a wave) takes its
    busiest block's chains (cps of them, each its k at the block's rate
    plus CHAIN_END) and BLOCK_START; then, where runs > 1, the tail,
    TAIL_LAUNCH and TAIL_RUN a cluster sum.

    On an H100 SXM (slots 132, 66, 30, 15, 7), at n = 100, d = 39,755,
    both routes: chains of 128, 112 slices in clusters of 16 (7 clusters,
    one wave, 3 chains a block); f32 at d = 5,460: chains of 64, 48
    slices in clusters of 16, 2 chains a block."""
    if n < 1 or d < 1 or sms < 1:
        raise ValueError(f"split_plan needs n, d, sms >= 1, got {n}, {d}, "
                         f"{sms}")
    slots = default_cluster_slots(sms) if slots is None else tuple(slots)
    nt = -(-n // TILE)
    tiles = nt * (nt + 1) // 2
    if bf16:
        base = mma_plan(n, d, sms)
        kgroups = 1
        chains = ((CHAIN,) if base.groups > 1 else
                  tuple(c for c in SPLIT_CHAINS if c >= base.stage_k))
    else:
        kgroups = gram_plan(n, d, sms).kgroups
        chains = SPLIT_CHAINS
    stage_k = base.stage_k if bf16 else 0
    best = None
    for chain in chains:
        total = -(-d // chain)
        for cluster, slot in zip(CLUSTERS, slots):
            if slot < 1:
                continue
            most = min(total // cluster,
                       max(1, SPLIT_WAVES * slot // tiles))
            for runs in range(1, most + 1):
                slices = cluster * runs
                plan = SplitPlan(n, d, bf16, tiles, chain, total,
                                 -(-total // slices), slices, cluster,
                                 kgroups, stage_k)
                key = (split_estimate(plan, sms, slots), slices, -chain)
                if best is None or key < best[0]:
                    best = (key, plan)
    return best[1]


def split_estimate(plan: SplitPlan, sms: int, slots: tuple) -> float:
    """:func:`split_plan`'s estimate of ``plan``'s time in seconds on a
    card with ``sms`` SMs and ``slots`` clusters of each size."""
    n = plan.n
    if plan.bf16:
        base = mma_plan(n, plan.d, sms)
        ops = 2 * MMA_ROWS * base.warpgroups * base.cols / base.groups
        t_k = SPLIT_BF16_SLOWDOWN * max(
            ops / SM_TENSOR_RATE, 2 * min(n, 2 * TILE) / SM_BYTES_RATE)
    else:
        mr = -(-n // THREAD_TILE)
        busy = mr * (mr + 1) // 2 if n <= TILE else THREADS
        t_k = busy * THREAD_TILE ** 2 / SPLIT_F32_RATE
    slot = slots[CLUSTERS.index(plan.cluster)]
    waves = -(-plan.tiles * plan.runs // slot)
    cost = waves * (plan.cps * (plan.chain * t_k + CHAIN_END) + BLOCK_START)
    if plan.runs > 1:
        cost += TAIL_LAUNCH + TAIL_RUN * plan.runs
    return cost


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


# --- the Gram split over d across the model axis --------------------------

# The most model positions the epilogue reads in one launch (their Grams'
# pointers travel by value: csrc/gram_split.cuh kMaxGrams).
EPILOGUE_MAX_POSITIONS = 32


class GramPartials(NamedTuple):
    """Stage 1's output for one model position's (n, d_j) column block:
    the block's (n, n) f32 Gram, on the position's device, as one
    slice."""

    ws: torch.Tensor
    n: int
    slices: int


@functools.lru_cache(maxsize=None)
def cluster_slots(index: int) -> tuple:
    """Clusters of each size in CLUSTERS card ``index`` holds at once, one
    block of the split stage 1 an SM (cudaOccupancyMaxActiveClusters)."""
    fn = _build.library("gram_partials").fl_cluster_slots
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    with torch.cuda.device(index):
        slots = tuple(fn(c) for c in CLUSTERS)
    if min(slots) < 0:
        raise RuntimeError(f"cluster_slots: the card refused the query "
                           f"(cudaError_t {-min(slots)})")
    return slots


def device_split_plan(G: torch.Tensor) -> SplitPlan:
    """:func:`split_plan` for G on its card."""
    n, d = G.shape
    index = (G.device.index if G.device.index is not None
             else torch.cuda.current_device())
    return split_plan(n, d, _sm_count(index), G.dtype == torch.bfloat16,
                      cluster_slots(index))


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
    operations, the block read once and its (n, n) f32 Gram written
    once."""
    return KernelCost(gram_operations(n, d),
                      (2 if bf16 else 4) * n * d + 4 * n * n,
                      "bf16" if bf16 else "fp32")


def gram_epilogue_cost(n: int, m: int) -> KernelCost:
    """Stage 2's work from the m model positions' (n, n) Grams: an add an
    entry a position and the epilogue's five operations an entry, each
    position's Gram read once and the distances written once."""
    return KernelCost((m + 5) * n * n, 4 * n * n * (m + 1))


@counted_kernel(lambda G, plan=None: gram_route("gram_partials", G),
                lambda G, plan=None: gram_partials_cost(
                    *G.shape, G.dtype == torch.bfloat16))
def gram_partials(G: torch.Tensor,
                  plan: Optional[SplitPlan] = None) -> GramPartials:
    """Stage 1 of the split Gram on one model position's (n, d_j) f32 or
    bf16 column block, on its device: the block's (n, n) f32 Gram.
    ``plan`` forces a :class:`SplitPlan` on the card (default
    :func:`device_split_plan`)."""
    n, d = G.shape
    if G.device.type == "cpu":
        return GramPartials(gram_partials_plain(G), n, 1)
    name = gram_route("gram_partials", G)
    _build.check_cuda_matrix(G, name)
    fn = _build.entry_point(name)
    plan = device_split_plan(G) if plan is None else plan
    # One allocation: the Gram's n rows, then the cluster sums' scratch.
    rows = n + -(-plan.mid_floats // n)
    out = torch.empty((rows, n), dtype=torch.float32, device=G.device)
    at = out.data_ptr()
    status = fn(G.data_ptr(), n, d, *plan.launch_args, at + 4 * n * n, at,
                _build.stream_handle(G))
    _build.check_status(name, status)
    _build.LAUNCHES[name] += 1
    return GramPartials(out.narrow(0, 0, n) if rows > n else out, n, 1)


@counted_kernel("gram_epilogue",
                lambda parts, device=None: gram_epilogue_cost(
                    parts[0].n, len(parts)))
def gram_epilogue(parts, device=None) -> torch.Tensor:
    """Stage 2 on ``device`` (default: the first part's): the (n, n) f32
    distances, exact zero diagonal, from the :class:`GramPartials` of
    every model position, in position order, read where they lie (a Gram
    on another card is copied over first)."""
    if len(parts) > EPILOGUE_MAX_POSITIONS:
        raise ValueError(f"gram_epilogue: {len(parts)} model positions, "
                         f"above the epilogue's cap of "
                         f"EPILOGUE_MAX_POSITIONS = "
                         f"{EPILOGUE_MAX_POSITIONS}")
    grams = [p.ws for p in parts]
    dev = grams[0].device if device is None else torch.device(device)
    kinds = {g.device.type for g in grams} | {dev.type}
    if kinds == {"cpu"}:
        return gram_epilogue_plain(grams)
    if kinds != {"cuda"}:
        raise ValueError(f"gram_epilogue: the partials and the device must "
                         f"all be CUDA or all CPU, got {sorted(kinds)}")
    n = parts[0].n
    for g in grams:
        if (g.dtype != torch.float32 or not g.is_contiguous()
                or g.shape != (n, n)):
            raise ValueError(f"gram_epilogue: expected contiguous float32 "
                             f"partials of ({n}, {n}), got {g.dtype} "
                             f"{tuple(g.shape)} "
                             f"contiguous={g.is_contiguous()}")
    fn = _build.entry_point("gram_epilogue")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    grams = [g if g.device == dev else g.to(dev) for g in grams]
    ptrs = (ctypes.c_void_p * len(grams))(*[g.data_ptr() for g in grams])
    D = torch.empty((n, n), dtype=torch.float32, device=dev)
    status = fn(ptrs, len(grams), n, D.data_ptr(), _build.stream_handle(D))
    _build.check_status("gram_epilogue", status)
    _build.LAUNCHES["gram_epilogue"] += 1
    return D
