"""The median kernels' sort route (csrc/trim_sort.cuh:median_sort_kernel),
without a card: a numpy model of the kernel's steps, held against the
port's plain versions, the JAX package's functions and its Pallas kernels
in interpret mode, and the route plan the median wrappers hand the
kernels (ops/defense_kernels.py:trim_plan, shared with the trimmed
means).

The model follows the kernel step by step on float32 and uint32 arrays
(one column per array column): the order-preserving keys with the
sentinel for dead rows and padding; Batcher's network, generated as the
header generates it (the helpers of tests/test_torch_port_trim_sort.py);
the picks at (e - 1) / 2 and e / 2 and their midpoint; and for the lower
weighted median the bisection over the sorted keys, each step a
row-order float32 sum of the alive weights at or below the candidate.
A median is a selection, so every comparison is exact.  The radix route
(csrc/coord_select.cuh:select_key) is modelled too: on the same keys
both routes pick the same two, so they agree bit for bit.

The kernels themselves run only on the card; chip_smoke.py holds them
against the plain versions and against each other there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attacking_federate_learning_tpu.defenses import kernels as jk
from attacking_federate_learning_tpu.defenses.median import (
    median as jax_median
)
from attacking_federate_learning_tpu.ops.pallas_defense import (
    pallas_masked_median, pallas_median_of
)
from attacking_federate_learning_tpu_torch.ops import _build
from attacking_federate_learning_tpu_torch.ops import defense_kernels as dk
from attacking_federate_learning_tpu_torch.ops.defense_kernels import (
    TrimPlan, masked_median_plain, median_of_plain, trim_plan
)
from test_torch_port_trim_sort import (
    SENTINEL, alie_cohort, dyadic_weights, from_ordered_key, network,
    ordered_key, run_network
)

D = 96
_NS = [1, 2, 13, 32, 33, 64, 65, 100, 128]


# -- the kernel's steps, in numpy ---------------------------------------------

def sorted_keys(G, alive, padded):
    """Steps 1 and 2: the alive rows' keys, sentinels below them, sorted by
    the generated network."""
    n, d = G.shape
    x = np.full((padded, d), SENTINEL, np.uint32)
    x[:n][alive] = ordered_key(G[alive])
    return run_network(x, network(padded, merge=False))


def weight_at_most(G, alive, w, t):
    """The alive weight of the rows whose key is at most t (per column),
    summed in row order in float32."""
    s = np.zeros(G.shape[1], np.float32)
    for i in np.flatnonzero(alive):
        s = np.where(ordered_key(G[i]) <= t, s + w[i], s)
    return s


def median_model(G, mask=None, weights=None, padded=None):
    """median_sort_kernel on an (n, d) float32 matrix: a dict with the
    output, e, the sorted keys and, weighted, the bisection's steps."""
    n, d = G.shape
    padded = trim_plan(n, d).padded if padded is None else padded
    alive = np.ones(n, bool) if mask is None else np.asarray(mask, bool)
    e = int(alive.sum())
    if e == 0:
        return {"out": np.full(d, np.inf, np.float32), "e": 0, "steps": 0}
    keys = sorted_keys(G, alive, padded)
    if weights is None:                                      # 3. median
        out = (from_ordered_key(keys[(e - 1) // 2])
               + from_ordered_key(keys[e // 2])) * np.float32(0.5)
        return {"out": out, "e": e, "keys": keys}
    w = np.asarray(weights, np.float32)
    total = np.float32(0.0)
    for i in np.flatnonzero(alive):
        total = np.float32(total + w[i])
    half = np.float32(total / np.float32(2.0))
    pos = np.zeros(d, np.int64)
    steps = 0
    if half > 0:
        step = 1 << (e - 1).bit_length() - 1 if e > 1 else 0
        cols = np.arange(d)
        while step >= 1:
            q = np.minimum(pos + step - 1, e - 1)
            fails = weight_at_most(G, alive, w, keys[q, cols]) < half
            pos = np.where(fails, pos + step, pos)
            step >>= 1
            steps += 1
    out = from_ordered_key(keys[pos, np.arange(d)])
    return {"out": out, "e": e, "keys": keys, "pos": pos, "half": half,
            "steps": steps}


def radix_key(G, alive, r):
    """coord_select.cuh:select_key: the r-th smallest alive key, one bit at
    a time from the top."""
    keys = ordered_key(G)
    ans = np.zeros(G.shape[1], np.uint32)
    for b in range(31, -1, -1):
        t = ans | np.uint32(1 << b)
        below = ((keys < t) & alive[:, None]).sum(0)
        ans = np.where(below <= r, t, ans)
    return ans


# -- cohorts ------------------------------------------------------------------

def make_mask(kind, n, seed):
    rng = np.random.default_rng(seed + 300)
    if kind == "all":
        return np.ones(n, bool)
    if kind == "random":
        return rng.random(n) < 0.8
    m = np.zeros(n, bool)
    alive = {"drop1": n - 1, "one": 1, "none": 0}[kind]
    m[rng.permutation(n)[:alive]] = True
    return m


def cohort(n, seed):
    """ALIE rows, ties (a few columns rounded to integers), -0 and +0."""
    G = alie_cohort(n, D, n // 4, seed)
    G[:, :8] = np.round(G[:, :8] * 2.0)
    G[::2, 8] = -0.0
    G[1::2, 8] = 0.0
    return G


# -- the model against the plain versions, JAX and Pallas --------------------

@pytest.mark.parametrize("n", _NS)
@pytest.mark.parametrize("kind", ["all", "drop1", "random", "one", "none"])
@pytest.mark.parametrize("weighted", [False, True])
def test_median_model_matches_plain_and_jax(n, kind, weighted):
    """Every alive count e (odd and even: n and n - 1), one alive and
    none (+inf), unweighted and on dyadic weights: the model equals the
    plain version, JAX's masked_median and median defense, and the
    Pallas kernel in interpret mode."""
    G = cohort(n, seed=n)
    m = make_mask(kind, n, seed=n)
    w = dyadic_weights(n, seed=n) if weighted else None
    got = median_model(G, m, w)["out"]
    tw = None if w is None else torch.from_numpy(w)
    plain = masked_median_plain(torch.from_numpy(G), torch.from_numpy(m),
                                tw).numpy()
    jw = None if w is None else jnp.asarray(w)
    xla = np.asarray(jk.masked_median(jnp.asarray(G), jnp.asarray(m),
                                      weights=jw))
    defense = np.asarray(jax_median(jnp.asarray(G), n, 0,
                                    mask=jnp.asarray(m), weights=jw))
    pallas = np.asarray(pallas_masked_median(
        jnp.asarray(G), jnp.asarray(m), weights=jw, weighted=weighted,
        interpret=True))
    for want in (plain, xla, defense, pallas):
        np.testing.assert_array_equal(got, want)
    if kind == "none":
        assert np.all(np.isposinf(got))
    if kind == "all" and not weighted:
        # The unmasked kernel: the same bits (no mask read, e = n).
        assert np.array_equal(median_model(G)["out"].view(np.uint32),
                              got.view(np.uint32))
        for want in (median_of_plain(torch.from_numpy(G)).numpy(),
                     np.asarray(jnp.median(G, axis=0)),
                     np.asarray(jax_median(jnp.asarray(G), n, 0)),
                     np.asarray(pallas_median_of(jnp.asarray(G),
                                                 interpret=True))):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", _NS)
def test_sort_and_radix_routes_pick_the_same_keys(n):
    """On columns with NaNs of both signs, infinities, ties and signed
    zeros, the sorted keys at (e - 1) / 2 and e / 2 are the radix route's
    selections, so the two routes' medians agree bit for bit; dead rows
    never reach them."""
    rng = np.random.default_rng(n + 7)
    G = cohort(n, seed=n + 1)
    specials = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0],
                        np.float32)
    hit = rng.random(G.shape) < 0.1
    G[hit] = rng.choice(specials, int(hit.sum()))
    for m in (np.ones(n, bool), make_mask("random", n, seed=n)):
        e = int(m.sum())
        if e == 0:
            continue
        keys = median_model(G, m)["keys"]
        for r in ((e - 1) // 2, e // 2):
            assert np.array_equal(keys[r], radix_key(G, m, r))
        lo, hi = radix_key(G, m, (e - 1) // 2), radix_key(G, m, e // 2)
        radix = (from_ordered_key(lo) + from_ordered_key(hi)) * np.float32(
            0.5)
        with np.errstate(invalid="ignore"):
            got = median_model(G, m)["out"]
        assert np.array_equal(got.view(np.uint32), radix.view(np.uint32))


@pytest.mark.parametrize("n", _NS)
def test_weighted_bisection_is_the_first_crossing(n):
    """The bisection takes floor(log2(e - 1)) + 1 <= 7 steps and lands on
    the first sorted key p with W(key <= x[p]) >= W / 2, the smallest
    alive value whose weight at or below it reaches half: the radix
    route's definition (coord_select.cuh:weighted_median)."""
    G = cohort(n, seed=n + 2)
    m = make_mask("random", n, seed=n + 2)
    m[0] = True
    w = dyadic_weights(n, seed=n + 2)
    w[::5] = 0.0                                  # rows without weight
    got = median_model(G, m, w)
    e = got["e"]
    assert got["steps"] == ((e - 1).bit_length() if e > 1 else 0) <= 7
    if got["half"] == 0:
        return
    keys = got["keys"]
    scan = np.full(G.shape[1], -1)
    for p in range(e - 1, -1, -1):
        reach = weight_at_most(G, m, w, keys[p]) >= got["half"]
        scan = np.where(reach, p, scan)
    assert np.array_equal(got["pos"], scan)
    alive = G[m]
    for c in range(G.shape[1]):
        v = got["out"][c]
        assert v in alive[:, c]
        assert w[m][alive[:, c] <= v].sum() >= got["half"]
        assert w[m][alive[:, c] < v].sum() < got["half"]


@pytest.mark.parametrize("n", [1, 13, 100])
def test_weighted_median_without_weight_is_the_first_alive_value(n):
    """half = 0 (every alive weight 0): no step runs and the pick is the
    smallest alive value, as JAX's argmax(cum >= 0) makes it."""
    G = cohort(n, seed=n + 3)
    m = make_mask("random", n, seed=n + 3)
    m[-1] = True
    w = np.where(m, 0.0, 1.0).astype(np.float32)
    got = median_model(G, m, w)
    assert got["steps"] == 0
    np.testing.assert_array_equal(got["out"], G[m].min(0))
    np.testing.assert_array_equal(got["out"], masked_median_plain(
        torch.from_numpy(G), torch.from_numpy(m), torch.from_numpy(w)))
    np.testing.assert_array_equal(got["out"], np.asarray(jk.masked_median(
        jnp.asarray(G), jnp.asarray(m), weights=jnp.asarray(w))))


def test_signed_zeros_give_plus_zero():
    """-0 and +0 share a key; the median of zeros comes out +0 (JAX may
    give -0, equal in value)."""
    G = np.zeros((13, 40), np.float32)
    G[::2] = -0.0
    G[5, ::3] = 1.0
    got = median_model(G)["out"]
    assert np.array_equal(got, median_of_plain(torch.from_numpy(G)).numpy())
    assert np.all(got.view(np.uint32) == 0)
    m = np.zeros(13, bool)
    m[::2] = True                                # only the -0 rows
    got = median_model(G, m)["out"]
    assert np.all(got.view(np.uint32) == 0)
    np.testing.assert_array_equal(got, np.asarray(jk.masked_median(
        jnp.asarray(G), jnp.asarray(m))))


@pytest.mark.parametrize("weighted", [False, True])
def test_padding_changes_no_bit(weighted):
    """A larger padding adds only sentinels, which sort after every alive
    key: the same bits."""
    G = cohort(52, seed=5)
    m = make_mask("random", 52, seed=5)
    w = dyadic_weights(52, seed=5) if weighted else None
    base = median_model(G, m, w)["out"].view(np.uint32)
    for padded in (56, 64, 100, 128):
        assert np.array_equal(
            median_model(G, m, w, padded=padded)["out"].view(np.uint32),
            base)


# -- the plan, through the median wrappers -----------------------------------

@pytest.fixture
def fake_launch(monkeypatch):
    """The median wrappers on a meta tensor, with the kernel library
    replaced by a recorder: the CUDA branch runs up to the C call, whose
    arguments are checked against the declared signature."""
    calls = []

    def entry_point(name):
        def fn(*args):
            assert len(args) == len(_build.KERNELS[name][2])
            calls.append((name, args))
            return 0
        return fn

    monkeypatch.setattr(_build, "check_cuda_matrix", lambda G, name: None)
    monkeypatch.setattr(_build, "check_cuda_rows", lambda *a: None)
    monkeypatch.setattr(_build, "entry_point", entry_point)
    monkeypatch.setattr(_build, "stream_handle", lambda G: 0)
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.KERNELS, 0))
    return calls


def _padded_arg(name, args):
    """The `padded` argument of fl_median / fl_masked_median."""
    return args[3] if name == "median" else args[6]


@pytest.mark.parametrize("n,padded", [(1, 32), (32, 32), (33, 36),
                                      (64, 64), (65, 68), (100, 100),
                                      (128, 128), (129, 0), (1000, 0)])
def test_median_wrappers_pass_the_shared_plan(n, padded, fake_launch):
    G = torch.empty((n, 79_510), device="meta")
    mask = torch.ones(n, dtype=torch.bool, device="meta")
    w = torch.ones(n, device="meta")
    dk.median_of(G)
    dk.masked_median(G, mask)
    dk.masked_median(G, mask, w)
    assert [(name, _padded_arg(name, args)) for name, args in fake_launch] \
        == [("median", padded), ("masked_median", padded),
            ("masked_median", padded)]
    assert [args[5] for name, args in fake_launch[1:]] == [0, 1]
    assert trim_plan(n, 79_510).padded == padded
    assert _build.LAUNCHES["median"] == 1
    assert _build.LAUNCHES["masked_median"] == 2


def test_median_wrappers_take_a_fitting_plan(fake_launch):
    G = torch.empty((100, 79_510), device="meta")
    mask = torch.ones(100, dtype=torch.bool, device="meta")
    for plan in (TrimPlan("select", 0), TrimPlan("sort", 112),
                 TrimPlan("sort", 128)):
        dk.median_of(G, plan)
        dk.masked_median(G, mask, None, plan)
    assert [_padded_arg(name, args) for name, args in fake_launch] == [
        0, 0, 112, 112, 128, 128]


@pytest.mark.parametrize("plan", [TrimPlan("sort", 96), TrimPlan("sort", 102),
                                  TrimPlan("sort", 132), TrimPlan("select", 32),
                                  TrimPlan("radix", 0)])
def test_median_wrappers_refuse_a_plan_that_does_not_fit(plan, fake_launch):
    G = torch.empty((100, 79_510), device="meta")
    mask = torch.ones(100, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="does not fit"):
        dk.median_of(G, plan)
    with pytest.raises(ValueError, match="does not fit"):
        dk.masked_median(G, mask, None, plan)
    assert fake_launch == []
    with pytest.raises(ValueError, match="does not fit"):
        dk.median_of(torch.empty((100, 2 ** 30), device="meta"),
                     TrimPlan("sort", 100))
