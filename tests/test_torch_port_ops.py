"""Plain PyTorch versions of the port's kernels vs the JAX package.

Each CUDA kernel of the port (attacking_federate_learning_tpu_torch/csrc)
has a plain PyTorch version beside its wrapper; on a CPU tensor the
wrapper runs that version.  Here the plain versions are held against the
JAX functions they replace, on the same seeded numpy cohorts: the Pallas
kernels in interpret mode (distances, trimmed mean) and, for the fused
Krum scores, the XLA scoring path ``_krum_scores`` (the Pallas Krum
kernel cannot trace under this JAX version).  The kernels themselves run
only on the card (chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attacking_federate_learning_tpu.defenses.kernels import (
    _krum_scores, krum_select
)
from attacking_federate_learning_tpu.ops.distances import (
    pairwise_distances as jax_pairwise_distances
)
from attacking_federate_learning_tpu.ops.pallas_defense import (
    pallas_trimmed_mean_of
)
from attacking_federate_learning_tpu.ops.pallas_distances import (
    pallas_pairwise_distances
)
from attacking_federate_learning_tpu_torch.ops.defense_kernels import (
    krum_scores, krum_scores_plain, trimmed_mean_of, trimmed_mean_of_plain
)
from attacking_federate_learning_tpu_torch.ops.distances import (
    pairwise_distances, pairwise_distances_plain
)

EPS = float(np.finfo(np.float32).eps)


def _cohort(n, d, f, attack, seed=0):
    """Attack-shaped (n, d) f32 cohort: ALIE's f identical crafted rows,
    a boosted backdoor-style row block, or none."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, d)).astype(np.float32)
    if attack == "alie":
        mu, sigma = G[f:].mean(0), G[f:].std(0)
        G[:f] = mu - 1.5 * sigma
    elif attack == "backdoor":
        G[:f] = 8.0 * rng.standard_normal(d).astype(np.float32)
    return G


def _pair_band(G, f=1):
    """Identical rows' zero distances come out of Gram cancellation:
    |d2 err| ~ eps*||g||^2, so each carries ~||g||*sqrt(2 eps) of
    order-dependent noise (4x margin); a Krum score sums up to f of them."""
    max_norm = float(np.max(np.linalg.norm(G, axis=1)))
    return 4.0 * max(f, 1) * max_norm * float(np.sqrt(2.0 * EPS))


_CASES = [(19, 300, 4, "none"), (21, 777, 5, "alie"),
          (32, 512, 8, "backdoor"), (13, 79, 3, "alie")]


@pytest.mark.parametrize("n,d,f,attack", _CASES)
def test_plain_distances_match_pallas_interpret(n, d, f, attack):
    G = _cohort(n, d, f, attack)
    want = np.asarray(pallas_pairwise_distances(
        jnp.asarray(G), bm=8, bn=8, bk=128, interpret=True))
    got = pairwise_distances_plain(torch.from_numpy(G)).numpy()
    # fp32 Gram in another summation order: relative rounding, plus the
    # cancellation band on identical crafted rows.
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=_pair_band(G))
    assert np.all(np.diag(got) == 0.0)


@pytest.mark.parametrize("n,d,f,attack", _CASES)
@pytest.mark.parametrize("paper_scoring", [False, True])
def test_plain_krum_scores_match_jax_scoring(n, d, f, attack,
                                             paper_scoring):
    G = _cohort(n, d, f, attack)
    D = jax_pairwise_distances(jnp.asarray(G))
    got, rowsum = krum_scores_plain(torch.from_numpy(G), f,
                                    paper_scoring=paper_scoring)
    got = got.numpy()
    band = _pair_band(G, f)
    for method in ("topk", "sort"):
        want = np.asarray(_krum_scores(D, n, f, paper_scoring=paper_scoring,
                                       method=method))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=band)
    # The winner is the defense's output: equal unless the reference's
    # own score gap sits inside the tie band.
    want_idx = int(krum_select(jnp.asarray(G), n, f,
                               paper_scoring=paper_scoring))
    got_idx = int(np.argmin(got))
    want = np.asarray(_krum_scores(D, n, f, paper_scoring=paper_scoring))
    assert got_idx == want_idx or abs(want[got_idx] - want[want_idx]) <= band
    np.testing.assert_allclose(
        rowsum.numpy(), np.asarray(D).sum(1), rtol=1e-5, atol=n * band)


@pytest.mark.parametrize("n,d,f,attack", _CASES + [(52, 400, 12, "alie")])
def test_plain_trimmed_mean_matches_pallas_interpret(n, d, f, attack):
    G = _cohort(n, d, f, attack)
    k = n - f - 1
    want = np.asarray(pallas_trimmed_mean_of(jnp.asarray(G), k,
                                             interpret=True))
    got = trimmed_mean_of_plain(torch.from_numpy(G), k).numpy()
    # Same median, same stable kept set; only the k-term sum's order
    # differs (the kernel test contract, tests/test_pallas.py).
    np.testing.assert_allclose(got, want, rtol=3e-6, atol=3e-6)


def _tie_cohort(n, d, seed):
    """Columns m + dev, dev = 0 (odd n) and +-j/4 for j = 1 .. n // 2 in a
    random row order per column: each |dev| but 0 ties exactly with its
    opposite, so which of a pair is kept decides the mean."""
    rng = np.random.default_rng(seed)
    j = np.arange(1, n // 2 + 1, dtype=np.float32) * 0.25
    dev = np.concatenate([np.zeros(n % 2, np.float32),
                          np.stack([j, -j], 1).ravel()])
    cols = rng.permuted(np.repeat(dev[:, None], d, axis=1), axis=0)
    return (cols + rng.integers(-16, 17, d)).astype(np.float32)


@pytest.mark.parametrize("n,k", [(13, 4), (64, 7), (300, 101)])
def test_plain_trimmed_mean_keeps_the_lower_row_of_a_tie(n, k):
    """k cuts through a +-dev pair in every column: the stable argsort
    keeps the member in the lower row, and the other choice moves the
    mean by 2 |dev| / k >= 0.25."""
    G = _tie_cohort(n, 37, seed=n)
    want = np.asarray(pallas_trimmed_mean_of(jnp.asarray(G), k,
                                             interpret=True))
    got = trimmed_mean_of_plain(torch.from_numpy(G), k).numpy()
    np.testing.assert_allclose(got, want, rtol=3e-6, atol=3e-6)
    # Keeping the higher row of the pair instead is caught.
    flipped = trimmed_mean_of_plain(torch.from_numpy(G[::-1].copy()), k)
    assert np.all(np.abs(flipped.numpy() - want) > 0.1)


def test_even_n_median_is_the_midpoint():
    """jnp.median's midpoint of the two middle values for even n, not
    torch.median's lower one: with k = 1 the trimmed mean is the value
    nearest that midpoint."""
    G = np.array([[0.0], [1.0], [10.0], [11.0]], np.float32)
    want = np.asarray(pallas_trimmed_mean_of(jnp.asarray(G), 4,
                                             interpret=True))
    got = trimmed_mean_of_plain(torch.from_numpy(G), 4).numpy()
    np.testing.assert_allclose(got, want)
    np.testing.assert_allclose(got, [5.5])


def test_wrappers_take_the_plain_version_on_cpu():
    G = torch.from_numpy(_cohort(21, 777, 5, "alie", seed=3))
    assert torch.equal(pairwise_distances(G), pairwise_distances_plain(G))
    for a, b in zip(krum_scores(G, 5), krum_scores_plain(G, 5)):
        assert torch.equal(a, b)
    assert torch.equal(trimmed_mean_of(G, 15), trimmed_mean_of_plain(G, 15))


def test_trimmed_mean_rejects_bad_keep_count():
    G = torch.zeros(5, 3)
    for k in (0, 6):
        with pytest.raises(ValueError, match="1 <= k <= n"):
            trimmed_mean_of(G, k)
