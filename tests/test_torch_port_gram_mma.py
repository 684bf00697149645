"""The bf16 route's Gram on the tensor cores (csrc/gram_mma.cuh), without a
card: the plan the wrappers hand it (ops/distances.py:mma_plan, at the
H100's 132 SMs), its block, warpgroup and accumulator-register numbering
(mirrored here in Python), its loader's arithmetic (aligned 16-byte words
realigned by the row's offset), and a numpy model of its summation order
held against the JAX package's Pallas bf16 route in interpret mode and
against fp64.

The kernel itself runs only on the card; chip_smoke.py holds it against
the plain versions there.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attacking_federate_learning_tpu.ops.pallas_distances import (
    pallas_pairwise_distances
)
from attacking_federate_learning_tpu_torch.ops.distances import (
    CHAIN, GROUPS, MMA_MAX_SMEM, MMA_ROWS, MMA_STAGE_K, MMA_STEP, TILE,
    gram_plan, mma_plan, pairwise_distances_plain
)

SMS = 132                       # an H100 SXM's SMs
EPS = float(np.finfo(np.float32).eps)
STEPS = CHAIN // MMA_STEP       # wgmma steps of a chain


def _kernel_chain():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.kernel_chain


SHAPES = [(1, 15), (2, 16), (10, 8_972_340), (16, 79), (17, 4099),
          (60, 79_510), (63, 4099), (64, 4099), (65, 4099), (100, 79_510),
          (128, 4099), (129, 4099), (257, 4099), (1000, 79_510),
          (5000, 79_510)]
EDGES = [1, 10, 16, 17, 63, 64, 65, 100, 128, 129, 1000]


# -- the plan ------------------------------------------------------------------

@pytest.mark.parametrize("n,d", SHAPES)
def test_slices_cover_d_in_whole_chains(n, d):
    plan = mma_plan(n, d, SMS)
    assert plan.chains == -(-d // CHAIN)
    per = plan.cps * CHAIN
    bounds = [(s * per, min((s + 1) * per, d)) for s in range(plan.slices)]
    assert bounds[0][0] == 0 and bounds[-1][1] == d
    for (a0, a1), (b0, _) in zip(bounds, bounds[1:]):
        assert a1 == b0 and a1 - a0 == per
    assert 0 < bounds[-1][1] - bounds[-1][0] <= per


@pytest.mark.parametrize("n,d", SHAPES)
def test_the_split_fills_every_sm(n, d):
    plan = mma_plan(n, d, SMS)
    if plan.tiles * plan.chains >= SMS:
        assert plan.tiles * plan.slices >= SMS
    else:
        assert plan.slices == plan.chains


@pytest.mark.parametrize("n,d,slices,cps,mb", [
    (100, 79_510, 156, 2, 10.303488), (60, 79_510, 156, 2, 10.303488),
    (1000, 79_510, 11, 29, 25.997312), (10, 8_972_340, 132, 266, 8.718336),
    (257, 4099, 17, 1, 6.710784), (1, 15, 1, 1, 0.066048)])
def test_workspace_bytes(n, d, slices, cps, mb):
    """The partial tiles and their diagonals, in the f32 route's layout
    (the shared epilogue reads it); fewer slices than the f32 route's
    plan where the Gram is one tile, as the tensor cores' chain costs
    about 15 times less."""
    plan = mma_plan(n, d, SMS)
    nt = -(-n // TILE)
    assert (plan.slices, plan.cps) == (slices, cps)
    assert plan.workspace_bytes == 4 * slices * (plan.tiles * TILE * TILE
                                                 + nt * TILE)
    assert plan.workspace_bytes == round(mb * 1e6)
    assert plan.slices <= gram_plan(n, d, SMS).slices


@pytest.mark.parametrize("n,d", SHAPES)
def test_rounding_chain_within_the_smoke_tests_bound(n, d):
    plan = mma_plan(n, d, SMS)
    runs = -(-plan.slices // plan.run_size)
    assert runs <= GROUPS
    assert plan.rounding_chain == (STEPS + plan.cps - 1 + plan.run_size - 1
                                   + runs - 1)
    assert plan.rounding_chain <= _kernel_chain()(d)


def test_plan_refuses_empty_shapes():
    for args in ((0, 5, SMS), (5, 0, SMS), (5, 5, 0)):
        with pytest.raises(ValueError, match="mma_plan"):
            mma_plan(*args)


@pytest.mark.parametrize("n", EDGES + [2, 32, 33, 5000])
def test_instruction_and_stage_fit_the_card(n):
    """One warpgroup of N = 64 up to 64 rows, two of 128 past; four (two)
    chains stacked in the 64 rows up to n = 16 (32), a stage then one
    chain a group; otherwise a stage of a power of two of k whose two
    swizzled stages, raw ring, tail and alignment fit a block's 227 KB,
    the largest such, its rows the busiest tile's live rows padded to
    8."""
    plan = mma_plan(n, 4099, SMS)
    assert plan.warpgroups == (1 if n <= MMA_ROWS else 2)
    assert plan.cols == (64 if n <= MMA_ROWS else 128)
    assert plan.groups == (4 if n <= 16 else 2 if n <= 32 else 1)
    nt = -(-n // TILE)
    assert plan.live == (n if nt <= 2 else 2 * TILE)
    assert plan.stage_k & (plan.stage_k - 1) == 0
    assert plan.smem_bytes <= MMA_MAX_SMEM
    if plan.groups > 1:
        assert plan.rows == MMA_ROWS and plan.live <= plan.rows // 2
        assert plan.stage_k == plan.groups * CHAIN
        # A group holds n rows.
        assert n <= MMA_ROWS // plan.groups
        return
    assert plan.rows % 8 == 0 and plan.live <= plan.rows <= 2 * TILE
    # Unstacked, a stage is at most one chain and divides it.
    lo, hi = MMA_STAGE_K
    assert lo <= plan.stage_k <= hi == CHAIN
    if plan.stage_k < hi:
        bigger = plan._replace(stage_k=2 * plan.stage_k)
        assert bigger.smem_bytes > MMA_MAX_SMEM


def test_stages_at_the_main_shapes():
    """n = 10: four chains stacked, 1,024 k a stage; n = 100: 128; n =
    1,000: 64, with 256 rows of two operands."""
    p = mma_plan(10, 8_972_340, SMS)
    assert (p.groups, p.stage_k, p.rows) == (4, 1024, 64)
    assert mma_plan(100, 79_510, SMS).stage_k == 128
    p = mma_plan(1000, 79_510, SMS)
    assert (p.stage_k, p.rows, p.live) == (64, 256, 256)


# -- the numbering ---------------------------------------------------------------

def tile_coords(t, nt):
    ti, length = 0, nt
    while t >= length:
        t -= length
        ti += 1
        length -= 1
    return ti, ti + t


def fragment(wg, warp, lane, regs):
    """(row, column) of each accumulator register of a thread of wgmma
    m64nNk16's f32 fragment, in its block's 128 x 128 tile."""
    out = []
    for i in range(regs):
        row = wg * 64 + warp * 16 + lane // 4 + 8 * ((i // 2) % 2)
        col = 8 * (i // 4) + 2 * (lane % 4) + i % 2
        out.append((row, col))
    return out


@pytest.mark.parametrize("n", EDGES)
def test_each_output_on_or_above_the_diagonal_once(n):
    """Every i <= j < n is computed and written by exactly one register of
    one thread of one block of a slice, and each row norm (the diagonal)
    by exactly one, on its diagonal tile; no write leaves the tile."""
    plan = mma_plan(n, 4099, SMS)
    nt = -(-n // TILE)
    # Stacked chains: group 0's warps write their block's registers.
    warps = 4 // plan.groups
    regs = plan.cols // 2 // plan.groups
    written, norms = {}, {}
    for t in range(plan.tiles):
        ti, tj = tile_coords(t, nt)
        ra = min(TILE, n - ti * TILE)
        for wg in range(plan.warpgroups):
            for warp in range(warps):
                for lane in range(32):
                    for row, col in fragment(wg, warp, lane, regs):
                        assert row < TILE and col < TILE
                        if row >= ra:
                            continue        # not written
                        i, j = ti * TILE + row, tj * TILE + col
                        if i <= j < n:
                            written[i, j] = written.get((i, j), 0) + 1
                        if ti == tj and row == col:
                            norms[i] = norms.get(i, 0) + 1
    pairs = {(i, j) for i in range(n) for j in range(i, n)}
    assert set(written) == pairs and set(written.values()) == {1}
    assert set(norms) == set(range(n)) and set(norms.values()) == {1}


@pytest.mark.parametrize("n", [1, 10, 16, 17, 32])
def test_stacked_chains_are_the_diagonal_blocks(n):
    """Where chains are stacked, the realign puts 16-byte chunk q of live
    row r at group q // (qrow / groups), row 64 / groups * group + r, line
    (q % (qrow / groups)) // 8, chunk q % 8 of the swizzled stage; one
    m64n64 step over the stage's 64 rows then holds, in its diagonal
    blocks, each chain's own step product, and the same block registers of
    every group's warps hold the same (i, j)."""
    plan = mma_plan(n, 4099, SMS)
    groups, stage_k = plan.groups, plan.stage_k
    R, qrow = MMA_ROWS // groups, stage_k // 8
    qg = qrow // groups
    rng = np.random.default_rng(n)
    G = rng.integers(-8, 9, (n, stage_k)).astype(np.float64)
    stage = np.zeros((stage_k // groups // 64, MMA_ROWS, 64))  # unswizzled
    for r in range(n):
        for q in range(qrow):
            grp, ql = divmod(q, qg)
            srow = R * grp + r
            stage[ql // 8, srow, 8 * (ql % 8):8 * (ql % 8) + 8] = \
                G[r, 8 * q:8 * q + 8]
    for step in range(CHAIN // MMA_STEP):
        line, sub = divmod(step, 4)
        A = stage[line, :, 16 * sub:16 * sub + 16]
        prod = A @ A.T                              # 64 x 64
        for g in range(groups):
            k = g * CHAIN + MMA_STEP * step
            want = G[:, k:k + MMA_STEP] @ G[:, k:k + MMA_STEP].T
            block = prod[R * g:R * g + n, R * g:R * g + n]
            assert np.array_equal(block, want)
    # Warp w of group g, register g * R / 2 + j: the same (i, j) of its
    # block as group 0's warp w % (R / 16), register j.
    for warp in range(4):
        g, w0 = divmod(warp, R // 16)
        for lane in range(32):
            mine = fragment(0, warp, lane, 32)[g * R // 2:(g + 1) * R // 2]
            base = fragment(0, w0, lane, R // 2)
            assert [(r - R * g, c - R * g) for r, c in mine] == base


# -- the loader --------------------------------------------------------------------

def realign(words, o):
    """gram_mma.cuh:realign on eight little-endian u32 words (two 16-byte
    words): the 16 bytes at byte offset o, by selects and a funnel
    shift."""
    x = [int(w) for w in words]
    t = [x[i + 1] if o & 4 else x[i] for i in range(7)]
    y = [t[i + 2] if o & 8 else t[i] for i in range(5)]
    s = (o & 3) * 8
    return [((y[i] | (y[i + 1] << 32)) >> s) & 0xFFFFFFFF for i in range(4)]


@pytest.mark.parametrize("d", [15, 16, 79, 4099, 1030])
@pytest.mark.parametrize("offset", [0, 2, 4, 6, 8, 10, 12, 14])
def test_aligned_words_realigned_give_every_row(d, offset):
    """Each live row's stage_k values from the qrow + 1 aligned 16-byte
    words that cover them, shifted by the row's address mod 16, values
    past the slice's end zeroed: the copies and the realign of
    gram_mma.cuh on a byte image of G placed ``offset`` bytes past a
    16-byte boundary (any even offset, any d)."""
    n, stage_k = 5, 64
    rng = np.random.default_rng(d + offset)
    G = rng.integers(1, 2 ** 16, (n, d), dtype=np.uint16)
    image = np.zeros(offset + 2 * n * d + 64, np.uint8)
    image[offset:offset + 2 * n * d] = G.view(np.uint8).ravel()
    qrow = stage_k // 8
    for k1 in (d, min(d, 40)):                  # the slice's end
        for kc in range(0, k1, stage_k):
            for r in range(n):
                row = offset + 2 * r * d         # the row's address
                start = (row + 2 * kc) & ~15
                words = []
                for w in range(qrow + 1):
                    src = start + 16 * w
                    ok = src < row + 2 * k1
                    chunk = (image[src:src + 16] if ok
                             else np.zeros(16, np.uint8))
                    words.append(np.frombuffer(chunk.tobytes(), np.uint32))
                o = row & 15
                for q in range(qrow):
                    v = realign(np.concatenate([words[q], words[q + 1]]), o)
                    got = np.array(v, np.uint32).view(np.uint16)
                    for j in range(8):
                        k = kc + 8 * q + j
                        if k >= k1:
                            got[j] = 0
                        want = G[r, k] if k < k1 else 0
                        assert got[j] == want, (r, kc, q, j)


# -- the summation order ------------------------------------------------------------

def emulate_mma_distances(G, plan, cps=None):
    """(n, d) f32 holding bf16 values -> (gram, D) summed in the tensor
    cores' order: each chain of 256 k is 16 steps of 16 k from zero, a
    step's 16 products summed exactly (fp64 holds them: bf16 products
    have 16 significant bits) and added to the chain's f32 sum with one
    rounding; per slice the first chain stored and the others added in
    order; the partials summed in runs of ceil(slices / 8) in order, the
    runs' sums in order; sq_i the summed diagonal; sqrt(max((sq_i + sq_j)
    - 2 g, 0)), zero diagonal.  Every (i, j) is computed, both halves."""
    n, d = G.shape
    cps = plan.cps if cps is None else cps
    G64 = G.astype(np.float64)
    partials = []
    for s in range(-(-plan.chains // cps)):
        k0, k1 = s * cps * CHAIN, min((s + 1) * cps * CHAIN, d)
        part = None
        for c0 in range(k0, k1, CHAIN):
            acc = np.zeros((n, n), np.float32)
            for q0 in range(c0, min(c0 + CHAIN, k1), MMA_STEP):
                blk = G64[:, q0:min(q0 + MMA_STEP, k1)]
                acc = (acc.astype(np.float64) + blk @ blk.T).astype(
                    np.float32)
            part = acc if part is None else part + acc
        partials.append(part)
    run = -(-len(partials) // GROUPS)
    sums = []
    for r0 in range(0, len(partials), run):
        v = partials[r0]
        for p in partials[r0 + 1:r0 + run]:
            v = v + p
        sums.append(v)
    gram = sums[0]
    for v in sums[1:]:
        gram = gram + v
    sq = np.diagonal(gram)
    d2 = (sq[:, None] + sq[None, :]) - np.float32(2.0) * gram
    D = np.sqrt(np.maximum(d2, np.float32(0.0)))
    np.fill_diagonal(D, 0.0)
    return gram, D


def _bf16_cohort(n, d, f, seed, at=0):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, d)).astype(np.float32)
    honest = np.concatenate([G[:at], G[at + f:]])
    G[at:at + f] = honest.mean(0) - 1.5 * honest.std(0)
    return torch.from_numpy(G).bfloat16().float().numpy()


@pytest.mark.parametrize("n,d,f,at,cps", [
    (9, 1000, 3, 0, None), (9, 1000, 3, 0, 2), (16, 1500, 4, 5, None),
    (12, 700, 5, 7, 1)])
def test_summation_order_gives_identical_rows_zero_and_symmetry(n, d, f,
                                                                at, cps):
    G = _bf16_cohort(n, d, f, n + d + at, at)
    plan = mma_plan(n, d, SMS)
    gram, D = emulate_mma_distances(G, plan, cps)
    assert D.dtype == np.float32
    rows = slice(at, at + f)
    # One order for every output: identical rows' Gram entries equal
    # their norms bit for bit, so their distances are exactly 0.
    assert np.array_equal(gram[rows, rows], np.full((f, f), gram[at, at]))
    assert np.all(D[rows, rows] == 0.0)
    assert np.array_equal(gram, gram.T) and np.array_equal(D, D.T)
    assert np.all(np.diag(D) == 0.0)
    # Against fp64 within 4 sqrt(L) eps (sq_i + sq_j) on the squares, L
    # the plan's rounding chain (phase 3's band)...
    G64 = G.astype(np.float64)
    sq64 = (G64 * G64).sum(1)
    scale = sq64[:, None] + sq64[None, :]
    ref2 = np.maximum(scale - 2.0 * G64 @ G64.T, 0)
    chain = mma_plan(n, d, SMS)._replace(
        cps=plan.cps if cps is None else cps).rounding_chain
    band_k = 4.0 * np.sqrt(chain) * EPS * scale
    assert np.all(np.abs(D.astype(np.float64) ** 2 - ref2) <= band_k)
    # ...and against the JAX package's Pallas bf16 route (its tile
    # product sums d in blocks of 512 k) and the port's plain version, in
    # phase 3's band against the plain version: both chains allowed.
    band = band_k + 4.0 * np.sqrt(d) * EPS * scale
    want = np.asarray(pallas_pairwise_distances(
        jnp.asarray(G).astype(jnp.bfloat16), interpret=True))
    assert np.all(np.abs(D.astype(np.float64) ** 2
                         - want.astype(np.float64) ** 2) <= band)
    plain = pairwise_distances_plain(torch.from_numpy(G)).double().numpy()
    assert np.all(np.abs(D.astype(np.float64) ** 2 - plain ** 2) <= band)
