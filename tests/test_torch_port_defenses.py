"""The port's defenses vs the JAX package's XLA defenses.

Selections (the Krum winner, Bulyan's selected set) must be equal, and
aggregates must agree within stated tolerances, on the same seeded numpy
cohorts.  On the CPU the port's kernel wrappers take their plain PyTorch
versions, so this holds the defense logic around the kernels (guard,
fallback, selection loop, trim tail) against the reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attacking_federate_learning_tpu.defenses import kernels as jk
from attacking_federate_learning_tpu_torch.defenses import kernels as tk
from attacking_federate_learning_tpu_torch.defenses import (
    DEFENSES, check_defense_args
)
from attacking_federate_learning_tpu_torch.ops.distances import (
    pairwise_distances
)


def _cohort(n, d, f, attack, seed=0):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, d)).astype(np.float32)
    if attack == "alie":
        mu, sigma = G[f:].mean(0), G[f:].std(0)
        G[:f] = mu - 1.5 * sigma
    elif attack == "backdoor":
        G[:f] = 8.0 * rng.standard_normal(d).astype(np.float32)
    return G


# Bulyan needs n >= 4f + 3.
_CASES = [(19, 300, 4, "alie"), (23, 333, 5, "alie"),
          (32, 512, 7, "backdoor"), (13, 79, 2, "none")]


@pytest.mark.parametrize("n,d,f,attack", _CASES)
@pytest.mark.parametrize("method", ["sort", "fused"])
def test_krum_selects_the_jax_winner(n, d, f, attack, method):
    G = _cohort(n, d, f, attack)
    want = int(jk.krum_select(jnp.asarray(G), n, f))
    got = int(tk.krum_select(torch.from_numpy(G), n, f, method=method))
    # ALIE's crafted rows are identical, so a winner among them is the
    # same row whatever its index.
    assert got == want or np.array_equal(G[got], G[want])
    np.testing.assert_array_equal(
        tk.krum(torch.from_numpy(G), n, f, method=method).numpy(),
        np.asarray(jk.krum(jnp.asarray(G), n, f)))


def test_fused_krum_guard_falls_back_to_the_exact_sort():
    """Reference-scale attacker magnitudes concentrate each rowsum in the
    complement, so the subtraction cancels; the guard must re-score with
    the exact sort and pick the XLA path's winner."""
    n, d, f = 19, 300, 4
    G = _cohort(n, d, f, "none")
    G[:f] *= 1e18
    want = int(jk.krum_select(jnp.asarray(G), n, f, distance_impl="xla"))
    got = int(tk.krum_select(torch.from_numpy(G), n, f, method="fused"))
    assert got == want


@pytest.mark.parametrize("n", [10, 19])
def test_guarded_krum_scores_at_f0_score_by_sort(n, monkeypatch):
    """At f = 0 the complement c = f - 1 is -1: with no complement to drop
    the guard scores exactly by sort, never through the fused kernel,
    which refuses c < 0; the winner is JAX's."""
    G = torch.from_numpy(_cohort(n, 200, 0, "none", seed=n))
    with pytest.raises(ValueError, match="f-1"):
        tk.krum_complement(n, 0)

    def refuse(*args, **kw):
        raise AssertionError("the fused Krum kernel ran at c < 0")

    monkeypatch.setattr(tk, "krum_scores", refuse)
    got = tk.guarded_krum_scores(G, n, 0)
    assert torch.equal(got, tk.sort_scores(pairwise_distances(G), n, 0))
    jwin = int(jk.krum_select(jnp.asarray(G.numpy()), n, 0))
    assert int(tk.krum_select(G, n, 0, method="fused")) == jwin


@pytest.mark.parametrize("n,d,f,attack", _CASES)
def test_trimmed_mean_matches_jax(n, d, f, attack):
    G = _cohort(n, d, f, attack)
    want = np.asarray(jk.trimmed_mean(jnp.asarray(G), n, f))
    got = tk.trimmed_mean(torch.from_numpy(G), n, f).numpy()
    # Same kept set; the k-term mean may round differently: a few ulp.
    np.testing.assert_allclose(got, want, rtol=3e-6, atol=3e-6)


@pytest.mark.parametrize("n,d,f,attack", _CASES)
def test_bulyan_selection_and_aggregate_match_jax(n, d, f, attack):
    G = _cohort(n, d, f, attack)
    want, diag = jk.bulyan(jnp.asarray(G), n, f, telemetry=True)
    want_set = set(np.flatnonzero(np.asarray(diag["selection_mask"])))
    Gt = torch.from_numpy(G)
    selected = tk.bulyan_select(pairwise_distances(Gt), n, f)
    assert len(selected) == n - 2 * f
    assert set(selected.tolist()) == want_set
    got = tk.bulyan(Gt, n, f).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=3e-6, atol=3e-6)


def test_no_defense_is_the_mean():
    G = _cohort(19, 300, 4, "alie")
    np.testing.assert_allclose(
        tk.no_defense(torch.from_numpy(G), 19, 4).numpy(),
        np.asarray(jk.no_defense(jnp.asarray(G), 19, 4)), rtol=1e-6,
        atol=1e-7)


def test_registry_and_validity_bounds():
    assert sorted(DEFENSES) == ["Bulyan", "CenteredClip", "DnC", "FLTrust",
                                "GeoMedian", "Krum", "Median", "NoDefense",
                                "NormBound", "TrimmedMean"]
    check_defense_args("Bulyan", 19, 4)
    with pytest.raises(ValueError, match="4\\*corrupted_count \\+ 3"):
        check_defense_args("Bulyan", 18, 4)
    with pytest.raises(ValueError, match="2\\*corrupted_count \\+ 1"):
        check_defense_args("Krum", 8, 4)
