"""The round's remaining knobs against the JAX package.

- ``bulyan_select`` with ``batch_select`` q = 1, 2, 4 against JAX's
  traced selection loop, unmasked and masked, on distance matrices of
  small integers (exact f32 sums, so scores tie exactly and the order of
  ties decides): the same selected set (JAX's telemetry selection mask),
  and the same aggregate.
- ``krum_scoring_method``: 'topk' and 'auto' (the JAX package's XLA
  suite) refused by the port's config and CLI, and the sort selection
  against JAX's.
- ``client_style_params``, the styled cohort batch and the metadata pool
  byte for byte, under 'femnist_style' with partial participation.
- The new CLI flags: JAX's names, defaults, choices and help, and the
  same config from the same argv.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attacking_federate_learning_tpu import cli as jax_cli
from attacking_federate_learning_tpu import config as JC
from attacking_federate_learning_tpu.config import (
    ExperimentConfig as JConfig
)
from attacking_federate_learning_tpu.core.engine import (
    FederatedExperiment as JExperiment
)
from attacking_federate_learning_tpu.data.datasets import (
    load_dataset as jax_load_dataset
)
from attacking_federate_learning_tpu.data.partition import (
    client_style_params as jax_style_params
)
from attacking_federate_learning_tpu.defenses.kernels import (
    bulyan as jax_bulyan, krum_select as jax_krum_select
)
from attacking_federate_learning_tpu_torch import cli
from attacking_federate_learning_tpu_torch import config as C
from attacking_federate_learning_tpu_torch.config import ExperimentConfig
from attacking_federate_learning_tpu_torch.core.engine import (
    FederatedExperiment
)
from attacking_federate_learning_tpu_torch.data.datasets import load_dataset
from attacking_federate_learning_tpu_torch.data.partition import (
    client_style_params, make_shards
)
from attacking_federate_learning_tpu_torch.defenses import kernels as K
from attacking_federate_learning_tpu_torch.ops.defense_kernels import (
    masked_trimmed_mean_plain, trimmed_mean_of_plain
)

SIZES = dict(synth_train=1200, synth_test=300)


def _tied_cohort(n, d, seed):
    """(n, d) gradients and an (n, n) symmetric zero-diagonal distance
    matrix of integers 1..6: its row sums are exact in f32, so Krum scores
    tie often and exactly."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, d), dtype=np.float32)
    U = np.triu(rng.integers(1, 7, (n, n)), 1).astype(np.float32)
    return G, U + U.T


@pytest.mark.parametrize("q", [1, 2, 4])
@pytest.mark.parametrize("n,f,seed", [(19, 4, 0), (23, 5, 1), (40, 9, 2),
                                      (12, 2, 3)])
def test_bulyan_batch_select_matches_jax(q, n, f, seed):
    G, D = _tied_cohort(n, 64, seed)
    selected = K.bulyan_select(torch.from_numpy(D), n, f, batch_select=q)
    set_size = n - 2 * f
    assert sorted(set(selected.tolist())) == sorted(selected.tolist())
    assert len(selected) == set_size
    want_agg, diag = jax_bulyan(jnp.asarray(G), n, f, D=jnp.asarray(D),
                                batch_select=q, telemetry=True)
    got_set = np.zeros(n, np.float32)
    got_set[selected.numpy()] = 1.0
    np.testing.assert_array_equal(got_set, np.asarray(diag["selection_mask"]))
    got_agg = trimmed_mean_of_plain(torch.from_numpy(G)[selected],
                                    set_size - 2 * f - 1)
    np.testing.assert_allclose(got_agg.numpy(), np.asarray(want_agg),
                               rtol=0, atol=1e-6)
    if q == 1:
        # q = 1 is the reference's sequential selection, whatever path.
        assert torch.equal(selected, K.bulyan_select(torch.from_numpy(D), n,
                                                     f))


@pytest.mark.parametrize("q", [1, 2, 4])
@pytest.mark.parametrize("n,f,seed,dead", [(19, 4, 4, (3, 7)),
                                           (23, 5, 5, (0, 1, 2, 20)),
                                           (40, 9, 6, (11,)),
                                           (12, 2, 7, tuple(range(8)))])
def test_masked_bulyan_batch_select_matches_jax(q, n, f, seed, dead):
    G, D = _tied_cohort(n, 64, seed)
    mask = np.ones(n, bool)
    mask[list(dead)] = False
    tmask = torch.from_numpy(mask)
    selected = K.bulyan_select(torch.from_numpy(D), n, f, mask=tmask,
                               batch_select=q)
    # The effective picks: the first e - 2f alive ones.
    alive = tmask[selected]
    eff = alive & (torch.cumsum(alive, 0) <= int(mask.sum()) - 2 * f)
    want_agg, diag = jax_bulyan(jnp.asarray(G), n, f, D=jnp.asarray(D),
                                batch_select=q, telemetry=True,
                                mask=jnp.asarray(mask))
    got_set = np.zeros(n, np.float32)
    got_set[selected.numpy()] = eff.numpy().astype(np.float32)
    np.testing.assert_array_equal(got_set, np.asarray(diag["selection_mask"]))
    got_agg = masked_trimmed_mean_plain(torch.from_numpy(G)[selected], eff,
                                        2 * f + 1)
    np.testing.assert_allclose(got_agg.numpy(), np.asarray(want_agg),
                               rtol=0, atol=1e-6)


def test_bulyan_refuses_a_bad_batch_select():
    _, D = _tied_cohort(11, 8, 0)
    with pytest.raises(ValueError, match="batch_select must be >= 1"):
        K.bulyan_select(torch.from_numpy(D), 11, 2, batch_select=0)


@pytest.mark.parametrize("method", ["topk", "auto"])
def test_krum_scoring_methods_of_the_xla_suite_are_refused(method):
    # Accepted by the JAX package's config, refused by the port's: its
    # Pallas suite never reaches them (the fused kernel outranks them).
    JConfig(krum_scoring_method=method)
    with pytest.raises(ValueError, match=f"krum_scoring_method='{method}' "
                                         f"is not ported"):
        ExperimentConfig(krum_scoring_method=method)
    args = cli.build_parser().parse_args(["--krum-scoring-method", method])
    with pytest.raises(ValueError, match="drop --krum-scoring-method"):
        cli.config_from_args(args)


@pytest.mark.parametrize("kind", ["normal", "huge"])
@pytest.mark.parametrize("n,f", [(19, 4), (30, 1), (19, 0), (40, 12)])
def test_krum_sort_select_matches_jax(n, f, kind):
    rng = np.random.default_rng(n + f)
    G = rng.standard_normal((n, 300), dtype=np.float32)
    if kind == "huge":
        # One row far away: a rowsum dominated by one distance.
        G[5] *= 1e4
    sel = K.krum_select(torch.from_numpy(G), n, f, method="sort")
    jsel = jax_krum_select(jnp.asarray(G), n, f, method="sort",
                           distance_impl="xla")
    assert int(sel) == int(jsel)


@pytest.mark.parametrize("method", ["heap", "topk", "auto"])
def test_krum_scoring_method_is_refused_when_unknown(method):
    with pytest.raises(ValueError, match="method must be 'sort' or 'fused'"):
        K.krum_select(torch.zeros(5, 3), 5, 1, method=method)


@pytest.mark.parametrize("n,strength,seed", [(20, 0.25, 0), (100, 0.5, 3),
                                             (7, 0.0, 11)])
def test_client_style_params_are_jax_s(n, strength, seed):
    a, b = client_style_params(n, strength, seed)
    ja, jb = jax_style_params(n, strength, seed)
    assert a.dtype == b.dtype == np.float32
    assert a.tobytes() == np.asarray(ja).tobytes()
    assert b.tobytes() == np.asarray(jb).tobytes()
    labels = np.arange(50) % 10
    assert np.array_equal(make_shards("femnist_style", labels, 5, seed),
                          make_shards("iid", labels, 5, seed))


@pytest.fixture(scope="module")
def datasets():
    return (jax_load_dataset(JC.SYNTH_MNIST_HARD, seed=0, **SIZES),
            load_dataset(C.SYNTH_MNIST_HARD, seed=0, **SIZES))


def _pair(datasets, **extra):
    kw = dict(dataset=C.SYNTH_MNIST_HARD, users_count=20, mal_prop=0.2,
              batch_size=16, **SIZES, **extra)
    return (JExperiment(JConfig(**kw), dataset=datasets[0]),
            FederatedExperiment(ExperimentConfig(**kw), dataset=datasets[1],
                                device="cpu"))


@pytest.mark.parametrize("participation", [1.0, 0.6])
def test_styled_batch_is_jax_s(participation, datasets):
    jexp, texp = _pair(datasets, partition="femnist_style",
                       style_strength=0.4, participation=participation)
    for t in (0, 3):
        part = texp.participants(t)
        jpart = None if part is None else jnp.asarray(part)
        jxs, _ = jexp._gather_batches(jnp.int32(t), jpart)
        want = np.asarray(jexp._apply_style(jxs, jpart))
        xs, _ = texp.gather_batches(t, part)
        got = texp.apply_style(xs, part).numpy()
        assert got.tobytes() == want.tobytes()
        assert not np.array_equal(got, np.asarray(jxs))


@pytest.mark.parametrize("partition", ["iid", "femnist_style"])
def test_metadata_pool_is_jax_s(partition, datasets):
    jexp, texp = _pair(datasets, partition=partition, collect_metadata=True)
    jx, jy = jexp.get_metadata()
    tx, ty = texp.get_metadata()
    assert tx.dtype == np.asarray(jx).dtype and ty.dtype == np.asarray(
        jy).dtype
    assert tx.tobytes() == np.asarray(jx).tobytes()
    assert ty.tobytes() == np.asarray(jy).tobytes()
    assert _pair(datasets)[1].get_metadata() is None


_FLAGS = ("participation", "local_steps", "partition", "dirichlet_alpha",
          "style_strength", "krum_scoring_method", "bulyan_batch_select",
          "distance_dtype", "server_uses_faded_lr")


def _actions(parser):
    return {a.dest: (a.option_strings, a.default, a.choices, a.help)
            for a in parser._actions if a.dest in _FLAGS}


def test_cli_flags_have_jax_s_names_defaults_choices_and_help():
    got, want = _actions(cli.build_parser()), _actions(jax_cli.build_parser())
    assert sorted(got) == sorted(_FLAGS)
    assert got == want


@pytest.mark.parametrize("argv", [
    [], ["--participation", "0.6", "--local-steps", "3"],
    ["--partition", "femnist_style", "--style-strength", "0.4"],
    ["--partition", "dirichlet", "--dirichlet-alpha", "0.3"],
    ["-d", "Krum", "--krum-scoring-method", "sort",
     "--distance-dtype", "bfloat16", "--server-uses-faded-lr"],
    ["-d", "Bulyan", "--bulyan-batch-select", "4"]])
def test_cli_builds_jax_s_config(argv):
    got = cli.config_from_args(cli.build_parser().parse_args(argv))
    want = jax_cli.config_from_args(jax_cli.build_parser().parse_args(argv))
    for name in _FLAGS:
        assert getattr(got, name) == getattr(want, name), name
    for name in ("grad_dtype", "collect_metadata", "metadata_fraction"):
        assert getattr(got, name) == getattr(want, name), name
