"""The trimmed-mean kernels' sort route (csrc/trim_sort.cuh), without a
card: a numpy model of the kernel's steps, held against the port's plain
versions and the JAX package's functions, and the route plan the wrappers
hand the kernels (ops/defense_kernels.py:trim_plan).

The model follows the kernel step by step on float32 and uint32 arrays
(one column per array column): the order-preserving keys with the
sentinel for dead rows and padding; the comparator networks, generated as
the header generates them, run as whole-array min/max; the median picks
at (e - 1) / 2 and e / 2; the |dev| bits in place and their bitonic merge;
T = the k-th smallest; the row-order walk that keeps every |dev| < T and
the first ``need`` ties, and its row-order sum.  Selections (the median,
the kept set) must be exact; a trimmed mean may differ from the plain
versions by the order of its k-term sum: k rounding steps of the largest
alive |g| (2x margin), twice that when weighted (two sums).

The kernels themselves run only on the card; chip_smoke.py holds them
against the plain versions there.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attacking_federate_learning_tpu.defenses import kernels as jk
from attacking_federate_learning_tpu_torch.ops.defense_kernels import (
    TrimPlan, _checked_plan, masked_median_plain, masked_trimmed_mean_plain,
    trim_plan, trimmed_mean_of_plain
)

EPS = float(np.finfo(np.float32).eps)
SENTINEL = np.uint32(0xFFFFFFFF)
TOP = np.uint32(0x80000000)
ABS = np.uint32(0x7FFFFFFF)
D_MLP = 79_510


# -- the kernel's pieces, in numpy --------------------------------------------

def ordered_key(x):
    """coord_select.cuh:ordered_key: (x + 0)'s bits u, ~u when negative,
    else u with the top bit set."""
    u = (np.asarray(x, np.float32) + np.float32(0.0)).view(np.uint32)
    return np.where(u & TOP, ~u, u | TOP).astype(np.uint32)


def from_ordered_key(o):
    """coord_select.cuh:from_ordered_key, its inverse."""
    o = np.asarray(o, np.uint32)
    return np.where(o & TOP, o & ABS, ~o).astype(np.uint32).view(np.float32)


def next_pow2(n):
    p = 1
    while p < n:
        p *= 2
    return p


def network(n, merge):
    """trim_sort.cuh:network: Batcher's odd-even merge sort, or the bitonic
    merge's half-cleaners, of the next power of two, without the
    comparators that touch an index >= n."""
    out = []
    if merge:
        h = next_pow2(n) // 2
        while h >= 1:
            out += [(i, i + h) for i in range(n) if i + h < n and not i & h]
            h //= 2
        return out
    p = 1
    while p < n:
        k = p
        while k >= 1:
            j = k % p
            while j + k < n:
                for i in range(min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        out.append((i + j, i + j + k))
                j += 2 * k
            k //= 2
        p *= 2
    return out


def run_network(x, net):
    """Each comparator a min/max over every column, in place."""
    for lo, hi in net:
        a, b = x[lo].copy(), x[hi].copy()
        x[lo] = np.minimum(a, b)
        x[hi] = np.maximum(a, b)
    return x


def model(G, mask, k_delta, weights=None, padded=None):
    """The kernel on an (n, d) float32 matrix.  Returns a dict with the
    output and the intermediate steps (None values where e = 0)."""
    n, d = G.shape
    padded = trim_plan(n, d).padded if padded is None else padded
    alive = np.ones(n, bool) if mask is None else np.asarray(mask, bool)
    e = int(alive.sum())
    if e == 0:
        return {"out": np.full(d, np.nan, np.float32), "e": 0}
    k = max(e - k_delta, 1)
    # 1. load, 2. sort
    x = np.full((padded, d), SENTINEL, np.uint32)
    x[:n][alive] = ordered_key(G[alive])
    keys = run_network(x.copy(), network(padded, merge=False))
    # 3. median
    med = (from_ordered_key(keys[(e - 1) // 2])
           + from_ordered_key(keys[e // 2])) * np.float32(0.5)
    # 4. |dev| bits (a sentinel becomes NaN's 0x7fffffff), merged
    with np.errstate(invalid="ignore"):
        devbits = (from_ordered_key(keys) - med).view(np.uint32) & ABS
    merged = run_network(devbits.copy(), network(padded, merge=True))
    T = merged[k - 1]
    need = k - (merged < T).sum(0)
    # 5. keep, in row order
    kept = np.zeros((n, d), bool)
    total = np.zeros(d, np.float32)
    mass = np.zeros(d, np.float32)
    left = need.copy()
    for i in range(n):
        dev = (G[i] + np.float32(0.0)) - med
        a = dev.view(np.uint32) & ABS
        tie = alive[i] & (a == T)
        keep = (alive[i] & (a < T)) | (tie & (left > 0))
        left -= tie
        kept[i] = keep
        if weights is None:
            total = np.where(keep, total + dev, total)
        else:
            wi = np.float32(weights[i])
            total = np.where(keep, total + wi * dev, total)
            mass = np.where(keep, mass + wi, mass)
    if weights is None:
        out = total / np.float32(k) + med
    else:
        out = total / np.maximum(mass, np.float32(1e-12)) + med
    return {"out": out.astype(np.float32), "e": e, "k": k, "keys": keys,
            "med": med, "devbits": devbits, "merged": merged, "T": T,
            "need": need, "kept": kept}


def stable_kept(G, alive, k):
    """The kept set of the JAX functions: a stable argsort of |G - med|
    with dead rows keyed +inf, its first k rows."""
    med = masked_median_plain(torch.from_numpy(G),
                              torch.from_numpy(alive)).numpy()
    key = np.where(alive[:, None], np.abs(G - med), np.inf)
    order = np.argsort(key, axis=0, kind="stable")
    kept = np.zeros(G.shape, bool)
    np.put_along_axis(kept, order[:k], True, axis=0)
    return kept


# -- cohorts ------------------------------------------------------------------

def alie_cohort(n, d, f, seed):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, d)).astype(np.float32)
    if f:
        mu, sigma = G[f:].mean(0), G[f:].std(0)
        G[:f] = mu - 1.5 * sigma
    return G


def tie_cohort(n, d, seed):
    """chip_smoke.py:tie_cohort: columns m + dev, dev = 0 (odd n) and
    +-j/4, j = 1 .. n // 2, in a random row order per column."""
    rng = np.random.default_rng(seed)
    j = np.arange(1, n // 2 + 1, dtype=np.float32) * 0.25
    dev = np.concatenate([np.zeros(n % 2, np.float32),
                          np.stack([j, -j], 1).ravel()])
    cols = rng.permuted(np.repeat(dev[:, None], d, axis=1), axis=0)
    return (cols + rng.integers(-16, 17, d)).astype(np.float32)


def make_mask(kind, n, k_delta, seed):
    rng = np.random.default_rng(seed + 100)
    alive = {"all": n, "random": None, "one": 1, "few": min(k_delta, n),
             "none": 0}[kind]
    if alive is None:
        return rng.random(n) < 0.85
    m = np.zeros(n, bool)
    m[rng.permutation(n)[:alive]] = True
    return m


def dyadic_weights(n, seed):
    rng = np.random.default_rng(seed + 200)
    return (rng.integers(1, 257, n) / 64.0).astype(np.float32)


def band(G, alive, k, weighted):
    scale = float(np.abs(G[alive]).max()) if alive.any() else 0.0
    return (2.0 if weighted else 1.0) * k * EPS * 2.0 * scale + 1e-7


# -- the networks -------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3, 5, 8, 11, 13, 16])
def test_sort_network_sorts_every_zero_one_input(n):
    """Batcher's pruned network sorts every 0/1 column, so it sorts every
    input (the 0-1 principle)."""
    cols = np.array(list(itertools.product([0, 1], repeat=n)),
                    np.uint32).T
    out = run_network(cols.copy(), network(n, merge=False))
    assert np.array_equal(out, np.sort(cols, axis=0))


@pytest.mark.parametrize("n", [2, 3, 5, 8, 11, 13, 16])
def test_merge_network_sorts_every_zero_one_v(n):
    """The pruned bitonic merge sorts every 0/1 column that falls, then
    rises (1..1 0..0 1..1): the shape the |dev| bits take."""
    cols = np.array([[1] * a + [0] * (n - a - b) + [1] * b
                     for a in range(n + 1) for b in range(n + 1 - a)],
                    np.uint32).T
    out = run_network(cols.copy(), network(n, merge=True))
    assert np.array_equal(out, np.sort(cols, axis=0))


@pytest.mark.parametrize("n", range(32, 129, 4))
def test_networks_sort_random_keys_at_every_padding(n):
    rng = np.random.default_rng(n)
    x = rng.integers(0, 2 ** 32, (n, 200), dtype=np.uint64).astype(np.uint32)
    x[:, :50] %= 7                                   # many equal keys
    x[n // 2:, 50:100] = SENTINEL                    # a sentinel tail
    out = run_network(x.copy(), network(n, merge=False))
    assert np.array_equal(out, np.sort(x, axis=0))
    # A V of random depth on each column, its tail sentinels.
    v = np.sort(x, axis=0)
    turn = rng.integers(0, n, 200)
    rows = np.arange(n)[:, None]
    vee = np.where(rows <= turn, v[::-1], v)
    vee[n - 3:, :20] = SENTINEL
    assert np.array_equal(run_network(vee.copy(), network(n, merge=True)),
                          np.sort(vee, axis=0))


@pytest.mark.parametrize("log2n,count", [(5, 191), (6, 543), (7, 1471)])
def test_comparator_counts(log2n, count):
    """Batcher's count (k^2 - k + 4) 2^(k-2) - 1 at powers of two, and
    log2(P) P / 2 for the merge; padding 100 drops 367 of 128's sort
    comparators and 132 of its merge's."""
    n = 2 ** log2n
    assert len(network(n, merge=False)) == count
    assert count == (log2n ** 2 - log2n + 4) * 2 ** (log2n - 2) - 1
    assert len(network(n, merge=True)) == log2n * n // 2
    assert len(network(100, merge=False)) == 1104
    assert len(network(100, merge=True)) == 316


def test_ordered_keys_order_floats_and_round_trip():
    """The keys order every finite float as its value (-0 folds into +0),
    put negative NaNs first and positive NaNs after +inf, and
    from_ordered_key gives back (x + 0)'s bits."""
    rng = np.random.default_rng(0)
    bits = np.concatenate([
        rng.integers(0, 2 ** 32, 20_000, dtype=np.uint64).astype(np.uint32),
        np.array([0, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000,
                  0xFFC00000, 0x7FFFFFFF, 0xFFFFFFFF, 1, 0x80000001,
                  0x007FFFFF, 0x807FFFFF], np.uint32)])
    x = bits.view(np.float32)
    with np.errstate(invalid="ignore"):
        keys = ordered_key(x)
        back = from_ordered_key(keys).view(np.uint32)
        assert np.array_equal(back, (x + np.float32(0.0)).view(np.uint32))
    assert ordered_key(np.float32(-0.0)) == ordered_key(np.float32(0.0))
    finite = np.isfinite(x)
    order = np.argsort(keys[finite], kind="stable")
    assert np.all(np.diff(x[finite][order]) >= 0)
    nan = np.isnan(x)
    neg = nan & (bits >> 31 == 1)
    assert np.all(keys[neg] < keys[~nan].min())
    assert np.all(keys[nan & ~neg] > keys[~nan].max())


# -- the model against the plain versions and JAX ----------------------------

_CASES = [(13, 2), (52, 12), (64, 15), (80, 19), (100, 24)]
_MASKS = ["all", "random", "one", "few", "none"]


@pytest.mark.parametrize("n,f", _CASES)
@pytest.mark.parametrize("kind", _MASKS)
@pytest.mark.parametrize("weighted", [False, True])
def test_model_matches_plain_and_jax(n, f, kind, weighted):
    d = 160
    G = alie_cohort(n, d, f, seed=n)
    k_delta = f + 1
    m = make_mask(kind, n, k_delta, seed=n)
    w = dyadic_weights(n, seed=n) if weighted else None
    got = model(G, None if kind == "all" and not weighted else m, k_delta, w)
    tw = None if w is None else torch.from_numpy(w)
    plain = masked_trimmed_mean_plain(torch.from_numpy(G),
                                      torch.from_numpy(m), k_delta,
                                      tw).numpy()
    jw = None if w is None else jnp.asarray(w)
    want = np.asarray(jk.masked_trimmed_mean_of(
        jnp.asarray(G), jnp.asarray(m), int(m.sum()) - k_delta, weights=jw))
    if kind == "none":
        assert got["e"] == 0
        assert np.all(np.isnan(got["out"])) and np.all(np.isnan(plain))
        assert np.all(np.isnan(want))
        return
    k = got["k"]
    assert k == max(int(m.sum()) - k_delta, 1)
    # Selections: the median and the kept set, exactly.
    med = masked_median_plain(torch.from_numpy(G), torch.from_numpy(m))
    assert np.array_equal(got["med"], med.numpy())
    assert np.array_equal(got["kept"], stable_kept(G, m, k))
    assert np.all(got["kept"].sum(0) == k)
    tol = band(G, m, k, weighted)
    np.testing.assert_allclose(got["out"], plain, rtol=1e-6, atol=tol)
    np.testing.assert_allclose(got["out"], want, rtol=1e-6, atol=tol)
    if not weighted and kind == "all":
        unmasked = np.asarray(jk.trimmed_mean_of(jnp.asarray(G), k))
        np.testing.assert_allclose(got["out"], unmasked, rtol=1e-6, atol=tol)
        np.testing.assert_allclose(
            got["out"], trimmed_mean_of_plain(torch.from_numpy(G), k).numpy(),
            rtol=1e-6, atol=tol)


@pytest.mark.parametrize("n,f", _CASES)
@pytest.mark.parametrize("kind", ["all", "random", "few"])
def test_dev_bits_are_bitonic_over_the_sorted_keys(n, f, kind):
    """Over the sorted keys (sentinels last) the |dev| bits fall, then
    rise: the merge's input shape.  The dead rows' bits, 0x7fffffff, are
    at least every alive |dev|."""
    G = alie_cohort(n, 120, f, seed=n + 1)
    m = make_mask(kind, n, f + 1, seed=n + 1)
    got = model(G, m, f + 1)
    bits = got["devbits"].astype(np.int64)
    step = np.diff(bits, axis=0)
    for c in range(bits.shape[1]):
        s = step[:, c]
        rising = np.nonzero(s > 0)[0]
        if rising.size:
            assert np.all(s[rising[0]:] >= 0)
    assert np.all(bits[got["e"]:] == 0x7FFFFFFF)
    assert np.all(bits[:got["e"]] <= 0x7FFFFFFF)
    assert np.array_equal(got["merged"], np.sort(got["devbits"], axis=0))


@pytest.mark.parametrize("n,k", [(13, 4), (64, 7)])
def test_tie_cohorts_keep_the_lower_row(n, k):
    """Every |dev| but 0 ties with its opposite, and k cuts through a pair
    in every column: only the stable kept set (lower row first) gives the
    plain versions' and JAX's mean, which is exact on these quarters."""
    G = tie_cohort(n, 500, seed=n)
    ones = np.ones(n, bool)
    got = model(G, None, n - k)
    assert np.array_equal(got["kept"], stable_kept(G, ones, k))
    plain = trimmed_mean_of_plain(torch.from_numpy(G), k).numpy()
    want = np.asarray(jk.trimmed_mean_of(jnp.asarray(G), k))
    assert np.array_equal(got["out"], plain)
    assert np.array_equal(got["out"], want)
    flipped = model(G[::-1].copy(), None, n - k)
    assert not np.array_equal(flipped["out"], got["out"])


@pytest.mark.parametrize("n", [13, 52, 80, 100])
def test_degenerate_masks(n):
    """e = 1 keeps the one alive row; e <= k_delta keeps one value (k =
    1); e = 0 is NaN, as in JAX."""
    G = alie_cohort(n, 90, n // 4, seed=7)
    k_delta = n // 4 + 1
    for alive in (1, k_delta - 1, k_delta):
        m = np.zeros(n, bool)
        m[np.random.default_rng(alive).permutation(n)[:alive]] = True
        got = model(G, m, k_delta)
        assert got["k"] == 1
        plain = masked_trimmed_mean_plain(torch.from_numpy(G),
                                          torch.from_numpy(m),
                                          k_delta).numpy()
        np.testing.assert_allclose(got["out"], plain, rtol=1e-6,
                                   atol=band(G, m, 1, False))
        if alive == 1:
            assert np.array_equal(got["out"], G[m][0])
    assert np.all(np.isnan(model(G, np.zeros(n, bool), k_delta)["out"]))


def test_signed_zeros_compare_equal():
    """-0 and +0 share a key; the port may return +0 where JAX gives -0,
    never another value."""
    G = np.zeros((13, 40), np.float32)
    G[::2] = -0.0
    G[5] = 1.0
    G[7, ::3] = -2.0
    for k in (1, 4, 7, 13):
        got = model(G, None, 13 - k)["out"]
        assert np.array_equal(
            got, trimmed_mean_of_plain(torch.from_numpy(G), k).numpy())
        assert np.array_equal(got, np.asarray(jk.trimmed_mean_of(
            jnp.asarray(G), k)))


def test_padding_and_an_all_true_mask_change_no_bit():
    """A larger padding adds only sentinels; an all-true mask is the
    unmasked kernel.  Both give the same bits."""
    G = alie_cohort(52, 200, 12, seed=3)
    ones = np.ones(52, bool)
    base = model(G, None, 13)["out"]
    for padded in (56, 64, 80, 128):
        assert np.array_equal(model(G, None, 13, padded=padded)["out"], base)
    assert np.array_equal(model(G, ones, 13)["out"], base)


def test_dyadic_weights_weight_the_kept_set():
    """The weighted mean sums w * dev over the same kept set; with dyadic
    weights and quarter-step ties it is exact."""
    n, k = 64, 7
    G = tie_cohort(n, 300, seed=5)
    w = dyadic_weights(n, seed=5)
    ones = np.ones(n, bool)
    got = model(G, ones, n - k, w)
    kept = stable_kept(G, ones, k)
    med = got["med"]
    want = (np.where(kept, w[:, None] * (G - med), 0).sum(0)
            / np.where(kept, w[:, None], 0).sum(0) + med)
    np.testing.assert_allclose(got["out"], want, rtol=1e-6, atol=1e-6)
    plain = masked_trimmed_mean_plain(torch.from_numpy(G),
                                      torch.from_numpy(ones), n - k,
                                      torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got["out"], plain, rtol=1e-6,
                               atol=band(G, ones, k, True))


# -- the route plan -----------------------------------------------------------

@pytest.mark.parametrize("n,route,padded", [
    (1, "sort", 32), (32, "sort", 32), (33, "sort", 36), (52, "sort", 52),
    (64, "sort", 64), (65, "sort", 68), (80, "sort", 80),
    (100, "sort", 100), (127, "sort", 128), (128, "sort", 128),
    (129, "select", 0), (1000, "select", 0)])
def test_trim_plan(n, route, padded):
    assert trim_plan(n, D_MLP) == TrimPlan(route, padded)
    assert _checked_plan(n, D_MLP, None) == TrimPlan(route, padded)


def test_trim_plan_keeps_the_stride_in_32_bits():
    assert trim_plan(100, 2 ** 30 - 1) == TrimPlan("sort", 100)
    assert trim_plan(100, 2 ** 30) == TrimPlan("select", 0)
    for bad in ((0, 5), (5, 0)):
        with pytest.raises(ValueError, match="trim_plan"):
            trim_plan(*bad)


@pytest.mark.parametrize("plan", [TrimPlan("sort", 96), TrimPlan("sort", 102),
                                  TrimPlan("sort", 132), TrimPlan("sort", 0),
                                  TrimPlan("select", 32),
                                  TrimPlan("radix", 0)])
def test_a_plan_that_does_not_fit_is_refused(plan):
    with pytest.raises(ValueError, match="does not fit"):
        _checked_plan(100, D_MLP, plan)


def test_any_fitting_plan_is_taken():
    for plan in (TrimPlan("select", 0), TrimPlan("sort", 100),
                 TrimPlan("sort", 112), TrimPlan("sort", 128)):
        assert _checked_plan(100, D_MLP, plan) == plan
    with pytest.raises(ValueError, match="does not fit"):
        _checked_plan(100, 2 ** 30, TrimPlan("sort", 100))


# -- chip_smoke.py's report of the sort route's build -------------------------

_PTXAS_LOG = """\
ptxas info    : 16 bytes gmem
ptxas info    : Compiling entry function '_ZN2fl16trim_sort_kernelILi112ELb0ELb0EEEvPKfPKhS2_ixiPf' for 'sm_90a'
ptxas info    : Function properties for _ZN2fl16trim_sort_kernelILi112ELb0ELb0EEEvPKfPKhS2_ixiPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 16 bytes smem
ptxas info    : Compiling entry function '_ZN2fl12coord_kernelILi4ELi0ELb0EEEvPKfPKhS2_ixiiPf' for 'sm_90a'
ptxas info    : Function properties for _ZN2fl12coord_kernelILi4ELi0ELb0EEEvPKfPKhS2_ixiiPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN2fl16trim_sort_kernelILi128ELb1ELb1EEEvPKfPKhS2_ixiPf' for 'sm_90a'
ptxas info    : Function properties for _ZN2fl16trim_sort_kernelILi128ELb1ELb1EEEvPKfPKhS2_ixiPf
    304 bytes stack frame, 356 bytes spill stores, 332 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 304 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN2fl18median_sort_kernelILi100ELb0ELb0EEEvPKfPKhS2_ixPf' for 'sm_90a'
ptxas info    : Function properties for _ZN2fl18median_sort_kernelILi100ELb0ELb0EEEvPKfPKhS2_ixPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 112 registers, used 1 barriers, 16 bytes smem
"""


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_reads_ptxas_reports(monkeypatch, capsys):
    """Each entry function's registers, stack frame and spills; a sort-
    route kernel (the trimmed means' or the medians') with a stack frame
    or a spill fails the smoke test, and so does a build whose log names
    no sort-route kernel of its own."""
    from attacking_federate_learning_tpu_torch.ops import _build

    mod = _chip_smoke()
    entries = mod.ptxas_entries(_PTXAS_LOG)
    assert [e[1:] for e in entries] == [(128, 0, 0, 0), (40, 0, 0, 0),
                                        (255, 304, 356, 332),
                                        (112, 0, 0, 0)]
    assert "trim_sort_kernelILi112" in entries[0][0]
    logs = {"trimmed_mean": _PTXAS_LOG, "masked_trimmed_mean": "",
            "median": _PTXAS_LOG, "masked_median": ""}
    monkeypatch.setattr(_build, "ptxas_log", logs.__getitem__)
    failures = []
    mod.sort_route_build(failures)
    out = capsys.readouterr().out
    assert "trim_sort_kernel<112, masked=0, weighted=0>: 128 registers" in out
    assert ("median_sort_kernel<100, masked=0, weighted=0>: 112 registers"
            in out)
    assert "coord_kernel" not in out
    # The median library's report names only its own kernels.
    assert out.count("[build] median ") == 1
    assert failures == ["trimmed_mean trim_sort_kernel<128>: stack frame or "
                        "spills",
                        "masked_trimmed_mean: no ptxas report of the sort "
                        "route",
                        "masked_median: no ptxas report of the sort route"]
    assert mod.route_of(trim_plan(100, D_MLP)) == "route=sort/100"
    assert mod.route_of(trim_plan(129, D_MLP)) == "route=select"


def test_chip_smoke_bit_equal_compares_bytes(capsys):
    """Two launches that both give NaN (e = 0) are the same bits; -0 and
    +0 are not."""
    mod = _chip_smoke()
    failures = []
    nan = torch.full((5,), float("nan"))
    mod.bit_equal("masked_trimmed_mean", "e=0", nan, nan.clone(), failures)
    mod.bit_equal("krum_scores", "pair", (torch.ones(3), nan),
                  (torch.ones(3), nan.clone()), failures)
    assert failures == []
    mod.bit_equal("median", "zeros", torch.tensor([-0.0]),
                  torch.tensor([0.0]), failures)
    assert failures == ["median zeros: not bit-equal"]
    assert "bit-equal=False" in capsys.readouterr().out
