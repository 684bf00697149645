"""The split of the distance kernels' Gram (csrc/gram_tile.cuh), without a
card: the plan the wrappers hand the kernels (ops/distances.py:gram_plan,
at the H100's 132 SMs), the kernels' block and thread-tile numbering
(mirrored here in Python), and a numpy float32 emulation of their
summation order, held against the JAX package's distances.

The kernels themselves run only on the card; chip_smoke.py holds them
against the plain versions there.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attacking_federate_learning_tpu.ops.distances import (
    pairwise_distances as jax_pairwise_distances
)
from attacking_federate_learning_tpu_torch.ops.distances import (
    CHAIN, GROUPS, TILE, gram_plan, pairwise_distances_plain
)

SMS = 132                       # an H100 SXM's SMs
TT = 8                          # thread tile edge (kTT)
TG = TILE // TT                 # thread tiles per tile edge (kTG)
EPS = float(np.finfo(np.float32).eps)


def _kernel_chain():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.kernel_chain


# -- the kernels' numbering, as gram_tile.cuh computes it --------------------

def tile_coords(t, nt):
    ti, length = 0, nt
    while t >= length:
        t -= length
        ti += 1
        length -= 1
    return ti, ti + t


def tile_index(ti, tj, nt):
    return ti * nt - ti * (ti - 1) // 2 + (tj - ti)


def live_thread_tiles(n, ti, tj):
    """(a, b) of each thread of a stage-1 block that computes, in thread
    order: the 8 x 8 thread tiles inside n, on or above the diagonal."""
    mr = min(TG, -(-(n - ti * TILE) // TT))
    mc = min(TG, -(-(n - tj * TILE) // TT))
    if ti != tj:
        return [(t // mc, t % mc) for t in range(mr * mc)]
    out = []
    for t in range(mr * (mr + 1) // 2):
        a, rem = 0, t
        while rem >= mr - a:
            rem -= mr - a
            a += 1
        out.append((a, a + rem))
    return out


SHAPES = [(100, 79_510), (1000, 79_510), (13, 79), (257, 4099),
          (129, 79_510), (257, 79_510), (80, 79_510), (1, 5), (9, 1000),
          (1000, 4099), (5000, 79_510)]


@pytest.mark.parametrize("nt", [1, 2, 3, 6, 8])
def test_each_tile_on_or_above_the_diagonal_once(nt):
    n = nt * TILE - 5
    plan = gram_plan(n, 1000, SMS)
    assert plan.tiles == nt * (nt + 1) // 2
    got = [tile_coords(t, nt) for t in range(plan.tiles)]
    assert sorted(got) == [(i, j) for i in range(nt) for j in range(i, nt)]
    assert [tile_index(i, j, nt) for i, j in got] == list(range(plan.tiles))


@pytest.mark.parametrize("n", [1, 9, 100, 128, 129, 200, 257, 300])
def test_each_output_is_computed_and_written_once(n):
    """Stage 1's live thread tiles cover every i <= j < n exactly once (a
    thread tile on the diagonal also computes the mirror entries, which
    no one reads); stage 2's blocks write every such pair exactly once."""
    nt = -(-n // TILE)
    computed, written = {}, {}
    for t in range(nt * (nt + 1) // 2):
        ti, tj = tile_coords(t, nt)
        tiles = live_thread_tiles(n, ti, tj)
        assert len(tiles) <= 256 and len(set(tiles)) == len(tiles)
        for a, b in tiles:
            for r in range(a * TT, a * TT + TT):
                for c in range(b * TT, b * TT + TT):
                    i, j = ti * TILE + r, tj * TILE + c
                    if i <= j < n:
                        computed[i, j] = computed.get((i, j), 0) + 1
        for r in range(TILE):
            for q in range(4):
                i, c0 = ti * TILE + r, 32 * q
                if i >= n or tj * TILE + c0 >= n or (ti == tj
                                                     and c0 + 31 < r):
                    continue
                for c in range(c0, c0 + 32):
                    j = tj * TILE + c
                    if j < n and (ti != tj or r <= c):
                        written[i, j] = written.get((i, j), 0) + 1
    pairs = {(i, j) for i in range(n) for j in range(i, n)}
    assert set(computed) == pairs and set(computed.values()) == {1}
    assert set(written) == pairs and set(written.values()) == {1}


def test_small_n_computes_only_the_upper_thread_tiles():
    """n = 100: 91 of the tile's 256 thread tiles (0.93 GFLOP in all at
    d = 79,510 instead of the padded tile's 2.6), each run by two k
    groups, so six warps do FMAs."""
    assert len(live_thread_tiles(100, 0, 0)) == 91
    flops = 2 * 91 * TT * TT * 79_510
    assert 0.9e9 < flops < 0.95e9
    assert gram_plan(100, 79_510, SMS).kgroups == 2


@pytest.mark.parametrize("n", [1, 13, 19, 52, 80, 81, 100, 120, 121, 128,
                               129, 1000])
def test_k_groups_only_where_every_tile_fits(n):
    """k groups split a block's threads; every tile of the launch must
    have a thread for each of its live thread tiles in every group, so
    they are used only when the Gram is one tile, and as many as fit."""
    kg = gram_plan(n, 1000, SMS).kgroups
    nt = -(-n // TILE)
    most = max(len(live_thread_tiles(n, *tile_coords(t, nt)))
               for t in range(nt * (nt + 1) // 2))
    assert kg in (1, 2, 4) and most <= 256 // kg
    if nt > 1:
        assert kg == 1
    elif kg < 4:
        assert most > 256 // (2 * kg)


@pytest.mark.parametrize("n,d", SHAPES)
def test_slices_cover_d_in_whole_chains(n, d):
    plan = gram_plan(n, d, SMS)
    assert plan.chains == -(-d // CHAIN)
    per = plan.cps * CHAIN                 # as the kernel cuts d
    bounds = [(s * per, min((s + 1) * per, d)) for s in range(plan.slices)]
    assert bounds[0][0] == 0 and bounds[-1][1] == d
    for (a0, a1), (b0, _) in zip(bounds, bounds[1:]):
        assert a1 == b0 and a1 - a0 == plan.cps * CHAIN
    assert 0 < bounds[-1][1] - bounds[-1][0] <= plan.cps * CHAIN


@pytest.mark.parametrize("n,d", SHAPES)
def test_the_split_fills_every_sm(n, d):
    plan = gram_plan(n, d, SMS)
    if plan.tiles * plan.chains >= SMS:
        assert plan.tiles * plan.slices >= SMS
    else:
        assert plan.slices == plan.chains


@pytest.mark.parametrize("n,d,slices,kg,mb", [
    (100, 79_510, 311, 2, 20.540928), (1000, 79_510, 11, 1, 25.997312),
    (13, 79, 1, 4, 0.066048), (257, 4099, 17, 1, 6.710784)])
def test_workspace_bytes(n, d, slices, kg, mb):
    """The partial tiles and, beside them, their diagonals."""
    plan = gram_plan(n, d, SMS)
    nt = -(-n // TILE)
    assert (plan.slices, plan.kgroups) == (slices, kg)
    assert plan.workspace_bytes == 4 * slices * (plan.tiles * TILE * TILE
                                                 + nt * TILE)
    assert plan.workspace_bytes == round(mb * 1e6)


@pytest.mark.parametrize("n,d", [(100, 79_510), (1000, 79_510), (13, 79),
                                 (257, 4099)])
def test_rounding_chain_within_the_smoke_tests_bound(n, d):
    plan = gram_plan(n, d, SMS)
    runs = -(-plan.slices // plan.run_size)
    assert runs <= GROUPS
    assert plan.rounding_chain <= _kernel_chain()(d)


def test_plan_refuses_empty_shapes():
    for args in ((0, 5, SMS), (5, 0, SMS), (5, 5, 0)):
        with pytest.raises(ValueError, match="gram_plan"):
            gram_plan(*args)


# -- the summation order ------------------------------------------------------

def _fma(a, b, c):
    """fp32 a*b + c, rounded once from the exact product (float64 holds
    the product of two float32 exactly; the sum may round twice in rare
    cases, which changes no property checked here)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def emulate_gram_distances(G, plan, cps=None, kgroups=None):
    """(n, d) f32 -> (n, n) distances summed in the kernels' order: k
    group g of ``kgroups`` takes k in [32g/kg, 32(g+1)/kg) of every chunk
    of 32, in FMA chains from 0 over its share of a 256-k chain; the
    groups' chains added in group order; per slice the first such chain
    stored and the others added in order; the slices' partials summed in
    runs of ceil(slices / 8) in order, and the runs' sums added in order;
    sq_i the summed diagonal; sqrt(max((sq_i + sq_j) - 2 g, 0)), zero
    diagonal.  Every (i, j) is computed, both halves, with no
    mirroring."""
    n, d = G.shape
    cps = plan.cps if cps is None else cps
    kg = plan.kgroups if kgroups is None else kgroups
    slices = -(-plan.chains // cps)
    partials = []
    for s in range(slices):
        k0, k1 = s * cps * CHAIN, min((s + 1) * cps * CHAIN, d)
        part = None
        for c0 in range(k0, k1, CHAIN):
            chain = None
            for g in range(kg):
                acc = np.zeros((n, n), np.float32)
                for k in range(c0, min(c0 + CHAIN, k1)):
                    if (k % 32) // (32 // kg) == g:
                        acc = _fma(G[:, k, None], G[None, :, k], acc)
                chain = acc if chain is None else chain + acc
            part = chain if part is None else part + chain
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


@pytest.mark.parametrize("cps,kgroups", [(None, None), (1, 1), (3, 2),
                                         (2, 1)])
def test_summation_order_gives_identical_rows_zero_and_symmetry(cps,
                                                                kgroups):
    n, d, f = 9, 1000, 3
    rng = np.random.default_rng(7)
    G = rng.standard_normal((n, d)).astype(np.float32)
    mu, sigma = G[f:].mean(0), G[f:].std(0)
    G[:f] = mu - 1.5 * sigma                      # ALIE's identical rows
    plan = gram_plan(n, d, SMS)
    assert (plan.slices, plan.cps, plan.kgroups) == (4, 1, 4)
    gram, D = emulate_gram_distances(G, plan, cps, kgroups)
    assert D.dtype == np.float32
    # The same order for every output: identical rows' Gram entries equal
    # their norms bit for bit, so their distances are exactly 0.
    assert np.array_equal(gram[:f, :f], np.full((f, f), gram[0, 0]))
    assert np.all(D[:f, :f] == 0.0)
    assert np.array_equal(gram, gram.T) and np.array_equal(D, D.T)
    assert np.all(np.diag(D) == 0.0)
    # Honest pairs keep their distance: held against float64 within
    # 4 sqrt(L) eps (sq_i + sq_j) on the squares (L the rounding chain)...
    G64 = G.astype(np.float64)
    sq64 = (G64 * G64).sum(1)
    ref2 = np.maximum(sq64[:, None] + sq64[None, :] - 2.0 * G64 @ G64.T, 0)
    band = 4.0 * np.sqrt(plan.rounding_chain) * EPS * (sq64[:, None]
                                                       + sq64[None, :])
    assert np.all(np.abs(D.astype(np.float64) ** 2 - ref2) <= band)
    # ...and against the JAX package's and the port's plain distances,
    # whose Gram runs in another order: relative rounding, plus the
    # cancellation noise those leave on the identical rows.
    noise = 4.0 * float(np.max(np.linalg.norm(G, axis=1))) * np.sqrt(2 * EPS)
    want = np.asarray(jax_pairwise_distances(jnp.asarray(G)))
    np.testing.assert_allclose(D, want, rtol=1e-5, atol=noise)
    plain = pairwise_distances_plain(torch.from_numpy(G)).numpy()
    np.testing.assert_allclose(D, plain, rtol=1e-5, atol=noise)
