"""Kernels 4-6 and the masked defenses of the port vs the JAX package.

The plain PyTorch versions of the median, masked trimmed mean and masked
median kernels (ops/defense_kernels.py) are held against the Pallas
kernels they replace, in interpret mode, and against the XLA functions
``masked_median`` / ``masked_trimmed_mean_of``, on the same seeded numpy
cohorts: unweighted and weighted, on ALIE cohorts (identical crafted
rows) and on the degenerate masks (one alive row, fewer alive rows than
the trim needs, none).  Medians and kept sets are selections and must be
exact; a trimmed mean sums its k kept deviations in another order than
XLA may, so it is held to k rounding steps of the largest |g| (2x
margin), twice that when weighted (two sums).  The kernels themselves run
only on the card (chip_smoke.py holds them against these plain versions
there).

Signed zero: the CUDA kernels key floats by an order-preserving map that
folds -0 into +0, and the plain versions sort with torch.sort, for which
-0 == +0, while jnp.sort puts -0 below +0.  A median may therefore come
out +0 where JAX gives -0 (or the other way round).  The two compare
equal, every later use of an aggregate is arithmetic (a sum with the
weights and velocity) in which the sign of an exact zero changes no
value, so the port keeps the cheaper key and the tests compare values.

The masked defenses are held against the JAX package's defenses with the
same ``mask=`` (and ``weights=``), and against the JAX survivor-submatrix
property of tests/test_faults.py: a defense given a quarantine mask
equals the same defense run on the alive rows alone.
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
    pallas_masked_median, pallas_masked_trimmed_mean, pallas_median_of
)
from attacking_federate_learning_tpu_torch.core.faults import (
    MASK_AWARE_DEFENSES
)
from attacking_federate_learning_tpu_torch.defenses import DEFENSES
from attacking_federate_learning_tpu_torch.defenses import kernels as tk
from attacking_federate_learning_tpu_torch.ops.defense_kernels import (
    masked_median, masked_median_plain, masked_trimmed_mean,
    masked_trimmed_mean_plain, median_of, median_of_plain, trimmed_mean_of
)

EPS = float(np.finfo(np.float32).eps)
JAX_DEFENSES = {"NoDefense": jk.no_defense, "Krum": jk.krum,
                "TrimmedMean": jk.trimmed_mean, "Bulyan": jk.bulyan,
                "Median": jax_median}


def _cohort(n, d, f, attack, seed=0):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, d)).astype(np.float32)
    if attack == "alie" and f:
        mu, sigma = G[f:].mean(0), G[f:].std(0)
        G[:f] = mu - 1.5 * sigma
    return G


def _mask(kind, n, k_delta, seed=0):
    rng = np.random.default_rng(seed + 100)
    alive = {"all": n, "random": None, "one": 1, "few": min(k_delta, n),
             "none": 0}[kind]
    if alive is None:
        return rng.random(n) < 0.75
    m = np.zeros(n, bool)
    m[rng.permutation(n)[:alive]] = True
    return m


def _weights(n, seed=0):
    return np.random.default_rng(seed + 200).uniform(
        0.1, 2.0, n).astype(np.float32)


def _trim_tol(G, mask, k, weighted):
    scale = float(np.abs(G[mask]).max()) if mask.any() else 0.0
    return (2.0 if weighted else 1.0) * k * EPS * 2.0 * scale + 1e-7


# (n, d, f, attack): registers (n <= 32, <= 64), an odd and an even n.
_SHAPES = [(19, 300, 4, "alie"), (20, 257, 4, "alie"), (13, 79, 0, "none"),
           (52, 130, 12, "alie")]
_MASKS = ["all", "random", "one", "few", "none"]


@pytest.mark.parametrize("n,d,f,attack", _SHAPES)
def test_plain_median_matches_pallas_interpret_and_jnp(n, d, f, attack):
    G = _cohort(n, d, f, attack)
    got = median_of_plain(torch.from_numpy(G)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(pallas_median_of(jnp.asarray(G), interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(jnp.median(G, axis=0)))


@pytest.mark.parametrize("n,d,f,attack", _SHAPES)
@pytest.mark.parametrize("kind", _MASKS)
@pytest.mark.parametrize("weighted", [False, True])
def test_plain_masked_median_matches_jax(n, d, f, attack, kind, weighted):
    G = _cohort(n, d, f, attack)
    m = _mask(kind, n, f + 1)
    w = _weights(n) if weighted else None
    G[~m] = 0.0                               # quarantine zeroes dead rows
    got = masked_median_plain(torch.from_numpy(G), torch.from_numpy(m),
                              None if w is None else torch.from_numpy(w))
    jw = None if w is None else jnp.asarray(w)
    want_pl = pallas_masked_median(jnp.asarray(G), jnp.asarray(m), weights=jw,
                                   weighted=weighted, interpret=True)
    want_xla = jk.masked_median(jnp.asarray(G), jnp.asarray(m), weights=jw)
    # A selection: exact (e = 0 gives +inf on every side).
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_pl))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_xla))
    if kind == "none":
        assert np.all(np.isposinf(got.numpy()))


@pytest.mark.parametrize("n,d,f,attack", _SHAPES)
@pytest.mark.parametrize("kind", _MASKS)
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("k_delta_of", ["f+1", "2f+1"])
def test_plain_masked_trimmed_mean_matches_jax(n, d, f, attack, kind,
                                               weighted, k_delta_of):
    G = _cohort(n, d, f, attack)
    k_delta = f + 1 if k_delta_of == "f+1" else 2 * f + 1
    m = _mask(kind, n, k_delta)
    w = _weights(n) if weighted else None
    G[~m] = 0.0
    got = masked_trimmed_mean_plain(
        torch.from_numpy(G), torch.from_numpy(m), k_delta,
        None if w is None else torch.from_numpy(w)).numpy()
    jw = None if w is None else jnp.asarray(w)
    want_pl = np.asarray(pallas_masked_trimmed_mean(
        jnp.asarray(G), jnp.asarray(m), k_delta, weights=jw,
        weighted=weighted, interpret=True))
    want_xla = np.asarray(jk.masked_trimmed_mean_of(
        jnp.asarray(G), jnp.asarray(m), int(m.sum()) - k_delta, weights=jw))
    k = max(int(m.sum()) - k_delta, 1)
    tol = _trim_tol(G, m, k, weighted)
    if kind == "none":
        # No alive row: the anchor is +inf and the one kept deviation
        # -inf, so every version returns NaN.
        assert np.all(np.isnan(got)) and np.all(np.isnan(want_pl))
        assert np.all(np.isnan(want_xla))
        return
    np.testing.assert_allclose(got, want_pl, rtol=1e-6, atol=tol)
    np.testing.assert_allclose(got, want_xla, rtol=1e-6, atol=tol)


@pytest.mark.parametrize("n,d,f,attack", _SHAPES)
def test_plain_masked_kernels_with_an_all_true_mask(n, d, f, attack):
    """An all-true mask is the unmasked estimator: the same median values,
    and the same kept set for k = n - k_delta (the CUDA kernels are then
    bit for bit the unmasked ones, which chip_smoke.py holds)."""
    G = torch.from_numpy(_cohort(n, d, f, attack))
    ones = torch.ones(n, dtype=torch.bool)
    assert torch.equal(masked_median_plain(G, ones), median_of_plain(G))
    np.testing.assert_allclose(
        masked_trimmed_mean_plain(G, ones, f + 1).numpy(),
        trimmed_mean_of(G, n - f - 1).numpy(), rtol=1e-6,
        atol=_trim_tol(G.numpy(), ones.numpy(), n - f - 1, False))


def test_weighted_median_is_the_lower_weighted_median():
    """The first sorted alive value whose cumulative weight reaches half
    the alive weight: with weights 1, 1, 1, 1 on 0, 1, 2, 3 that is 1 (the
    lower of the middle pair), and moving weight onto 3 moves it there."""
    G = np.array([[2.0], [0.0], [3.0], [1.0], [-5.0]], np.float32)
    m = np.array([True, True, True, True, False])
    for w, want in (([1, 1, 1, 1, 9], 1.0), ([1, 1, 5, 1, 9], 3.0),
                    ([2, 1, 1, 1, 9], 2.0)):
        w = np.asarray(w, np.float32)
        got = masked_median_plain(torch.from_numpy(G), torch.from_numpy(m),
                                  torch.from_numpy(w)).numpy()
        jax_got = np.asarray(jk.masked_median(jnp.asarray(G), jnp.asarray(m),
                                              weights=jnp.asarray(w)))
        np.testing.assert_array_equal(got, [want])
        np.testing.assert_array_equal(jax_got, [want])


def test_signed_zero_medians_compare_equal():
    """A column whose middle values are -0 and +0: the port and JAX may
    differ in the sign of the zero they return, never in its value."""
    G = np.array([[-0.0, 1.0], [0.0, -0.0], [-0.0, 0.0], [2.0, -1.0]],
                 np.float32)
    m = np.array([True, True, True, False])
    got = masked_median_plain(torch.from_numpy(G), torch.from_numpy(m))
    want = jk.masked_median(jnp.asarray(G), jnp.asarray(m))
    assert np.array_equal(got.numpy(), np.asarray(want))   # -0 == +0
    got = median_of_plain(torch.from_numpy(G)).numpy()
    assert np.array_equal(got, np.asarray(jnp.median(G, axis=0)))


def test_wrappers_take_the_plain_version_on_cpu():
    G = torch.from_numpy(_cohort(21, 77, 5, "alie", seed=3))
    m = torch.from_numpy(_mask("random", 21, 6, seed=3))
    w = torch.from_numpy(_weights(21, seed=3))
    assert torch.equal(median_of(G), median_of_plain(G))
    for weights in (None, w):
        assert torch.equal(masked_median(G, m, weights),
                           masked_median_plain(G, m, weights))
        assert torch.equal(masked_trimmed_mean(G, m, 6, weights),
                           masked_trimmed_mean_plain(G, m, 6, weights))
    with pytest.raises(ValueError, match="k_delta >= 0"):
        masked_trimmed_mean(G, m, -1)


# ---------------------------------------------------------------------------
# the masked defenses

# Bulyan needs n >= 4f + 3.
_DEF_CASES = [(19, 300, 4, "alie"), (23, 333, 5, "alie"), (13, 40, 2, "none"),
              (12, 30, 2, "alie")]


def _masked_inputs(n, d, f, attack, seed=0):
    G = _cohort(n, d, f, attack, seed)
    m = _mask("random", n, f + 1, seed)
    m[f] = True                               # at least one honest alive
    G[~m] = 0.0
    return G, m


@pytest.mark.parametrize("name", sorted(MASK_AWARE_DEFENSES))
@pytest.mark.parametrize("n,d,f,attack", _DEF_CASES)
def test_masked_defense_matches_jax(name, n, d, f, attack):
    G, m = _masked_inputs(n, d, f, attack)
    want = np.asarray(JAX_DEFENSES[name](jnp.asarray(G), n, f,
                                         mask=jnp.asarray(m)))
    got = DEFENSES[name](torch.from_numpy(G), n, f,
                         mask=torch.from_numpy(m)).numpy()
    # Krum and Median return selected values; the means sum in another
    # order (a few ulp).
    np.testing.assert_allclose(got, want, rtol=3e-6, atol=3e-6)


@pytest.mark.parametrize("name", sorted(MASK_AWARE_DEFENSES))
@pytest.mark.parametrize("n,d,f,attack", _DEF_CASES[:2])
def test_weighted_masked_defense_matches_jax(name, n, d, f, attack):
    G, m = _masked_inputs(n, d, f, attack, seed=1)
    w = _weights(n, seed=1)
    want = np.asarray(JAX_DEFENSES[name](jnp.asarray(G), n, f,
                                         mask=jnp.asarray(m),
                                         weights=jnp.asarray(w)))
    got = DEFENSES[name](torch.from_numpy(G), n, f, mask=torch.from_numpy(m),
                         weights=torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-6, atol=3e-6)


@pytest.mark.parametrize("name", sorted(MASK_AWARE_DEFENSES))
def test_masked_defense_matches_survivor_submatrix(name):
    """tests/test_faults.py:test_masked_kernel_matches_survivor_submatrix
    for the port: the quarantine mask reproduces the shrunk-cohort
    estimator exactly."""
    rng = np.random.default_rng(7)
    n, f, d = 13, 2, 40
    G = rng.standard_normal((n, d)).astype(np.float32)
    dead = [3, 8]
    mask = np.array([i not in dead for i in range(n)])
    Gz = G.copy()
    Gz[dead] = 0.0
    keep = [i for i in range(n) if i not in dead]
    got = DEFENSES[name](torch.from_numpy(Gz), n, f,
                         mask=torch.from_numpy(mask)).numpy()
    want = DEFENSES[name](torch.from_numpy(G[keep]), len(keep), f).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("name", sorted(MASK_AWARE_DEFENSES))
def test_all_alive_mask_matches_unmasked(name):
    rng = np.random.default_rng(11)
    n, f = 12, 2
    G = torch.from_numpy(rng.standard_normal((n, 30)).astype(np.float32))
    np.testing.assert_allclose(
        DEFENSES[name](G, n, f).numpy(),
        DEFENSES[name](G, n, f, mask=torch.ones(n, dtype=torch.bool)).numpy(),
        atol=1e-6)


@pytest.mark.parametrize("name", sorted(MASK_AWARE_DEFENSES))
def test_weights_without_a_mask_are_refused(name):
    G = torch.zeros(9, 4)
    with pytest.raises(ValueError, match="weights= requires mask="):
        DEFENSES[name](G, 9, 1, weights=torch.ones(9))


@pytest.mark.parametrize("n,d,f,attack", _DEF_CASES)
def test_masked_bulyan_selects_the_jax_set(n, d, f, attack):
    """The selection loop with the dead-row sentinel picks JAX's set: the
    first e - 2f alive picks, which are the rows the trim uses."""
    G, m = _masked_inputs(n, d, f, attack, seed=2)
    _, diag = jk.bulyan(jnp.asarray(G), n, f, mask=jnp.asarray(m),
                        telemetry=True)
    want = set(np.flatnonzero(np.asarray(diag["selection_mask"])))
    Gt, mt = torch.from_numpy(G), torch.from_numpy(m)
    sel = tk.bulyan_select(tk.pairwise_distances(Gt), n, f, mask=mt)
    assert len(sel) == n - 2 * f
    alive = [int(i) for i in sel if m[int(i)]][:int(m.sum()) - 2 * f]
    assert set(alive) == want


def test_masked_krum_scores_by_sort_not_the_fused_kernel(monkeypatch):
    """Under a mask the engine's method='fused' Krum scores exactly by sort
    over the distance kernel (the fused kernel's complement identity
    assumes the static pool): the fused wrapper is never called."""
    def refuse(*args, **kwargs):
        raise AssertionError("the fused Krum kernel ran under a mask")

    monkeypatch.setattr(tk, "krum_scores", refuse)
    n, d, f = 19, 300, 4
    G, m = _masked_inputs(n, d, f, "alie", seed=3)
    got = tk.krum(torch.from_numpy(G), n, f, method="fused",
                  mask=torch.from_numpy(m)).numpy()
    want = np.asarray(jk.krum(jnp.asarray(G), n, f, mask=jnp.asarray(m)))
    np.testing.assert_array_equal(got, want)
    assert m[int(np.flatnonzero((G == got).all(1))[0])]    # an alive row


@pytest.mark.parametrize("paper_scoring", [False, True])
def test_masked_sort_scores_match_jax(paper_scoring):
    n, d, f = 19, 300, 4
    G, m = _masked_inputs(n, d, f, "alie", seed=4)
    D = jk.pairwise_distances(jnp.asarray(G))
    want = np.asarray(jk._krum_scores(D, int(m.sum()), f,
                                      alive=jnp.asarray(m),
                                      paper_scoring=paper_scoring))
    got = tk.sort_scores(torch.from_numpy(np.array(D)),
                         torch.tensor(int(m.sum())), f, paper_scoring,
                         alive=torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.all(np.isposinf(got[~m]))
