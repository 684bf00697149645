"""The port's beyond-reference defenses vs the JAX package's.

DnC, GeoMedian, CenteredClip, FLTrust and NormBound (the JAX package's
``defenses/dnc.py``, ``geomed.py``, ``centeredclip.py``, ``fltrust.py``
and ``normbound.py``), on the CPU where each takes its plain version:

- DnC's draws bit for bit: the threefry kernel's plain version against
  utils/threefry.py, the device permutation and ``choice`` against
  ``jax.random`` (two shuffle rounds at d = 79,510, three past 2.64
  million), the sketch keys; the normal start within the erfinv band
  below;
- each defense against the JAX function on the same numpy matrices, with
  the tolerance stated where it is used (sums in other orders: a few f32
  ulp of the aggregate); DnC's survivor set exactly JAX's telemetry
  ``survivor_mask`` (r < d, r = d, f = 0, an empty intersection, ALIE's
  identical rows tied at the keep boundary), its per-iteration scores
  within 1e-4 of the largest and every keep set exact where the boundary
  gap is clear of that band;
- FLTrust's bf16-wire promotions (a bf16 row norm, f32 trust weights, an
  f32 aggregate) and NormBound's midpoint bound at even and odd n;
- the config's seven fields (JAX's defaults, checks and messages), the
  CLI's ``-d`` choices and seven flags with JAX's help texts, and the
  refusals under faults and async rounds word for word;
- three rounds of each defense through the engine against the JAX
  package's XLA engine (SYNTH_MNIST_HARD, n = 19, f = 4, one explicit
  dataset for both engines), FLTrust also under 'femnist_style' and on a
  bf16 wire, DnC also at participation 0.6: weights within atol 1e-5
  (tests/test_torch_port_round.py's band).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attacking_federate_learning_tpu import cli as jax_cli
from attacking_federate_learning_tpu import config as JC
from attacking_federate_learning_tpu.attacks import DriftAttack as JDrift
from attacking_federate_learning_tpu.config import (
    ExperimentConfig as JConfig, FaultConfig as JFaultConfig
)
from attacking_federate_learning_tpu.core.engine import (
    FederatedExperiment as JExperiment
)
from attacking_federate_learning_tpu.data.datasets import (
    load_dataset as jax_load_dataset
)
from attacking_federate_learning_tpu.defenses.centeredclip import (
    centered_clip as jax_cclip
)
from attacking_federate_learning_tpu.defenses.fltrust import (
    fltrust as jax_fltrust
)
from attacking_federate_learning_tpu.defenses.geomed import (
    geometric_median as jax_geomed
)
from attacking_federate_learning_tpu.defenses.normbound import (
    norm_bounded_mean as jax_normbound
)
from attacking_federate_learning_tpu_torch import cli
from attacking_federate_learning_tpu_torch import config as C
from attacking_federate_learning_tpu_torch.attacks import DriftAttack
from attacking_federate_learning_tpu_torch.config import (
    ExperimentConfig, FaultConfig
)
from attacking_federate_learning_tpu_torch.core.engine import (
    FederatedExperiment
)
from attacking_federate_learning_tpu_torch.core.server import (
    init_server_state
)
from attacking_federate_learning_tpu_torch.data.datasets import load_dataset
from attacking_federate_learning_tpu_torch.defenses import DEFENSES
from attacking_federate_learning_tpu_torch.defenses import dnc as D
from attacking_federate_learning_tpu_torch.defenses.centeredclip import (
    centered_clip
)
from attacking_federate_learning_tpu_torch.defenses.fltrust import (
    fltrust, row_norms
)
from attacking_federate_learning_tpu_torch.defenses.geomed import (
    geometric_median
)
from attacking_federate_learning_tpu_torch.defenses.normbound import (
    norm_bounded_mean
)
from attacking_federate_learning_tpu_torch.ops import threefry_bits as R
from attacking_federate_learning_tpu_torch.utils import threefry
from attacking_federate_learning_tpu_torch.utils.weights import (
    from_jax_params
)

# The module, not the function the package's __init__ binds to its name.
jdnc = importlib.import_module("attacking_federate_learning_tpu.defenses.dnc")

NEW = ("DnC", "GeoMedian", "CenteredClip", "FLTrust", "NormBound")
N, MAL_PROP, B, ROUNDS = 19, 0.22, 32, 3
SIZES = dict(synth_train=1200, synth_test=300)
EPS = float(np.finfo(np.float32).eps)


def grads(n, d, seed, alie=0):
    """Seeded (n, d) f32 normals; with ``alie`` the first rows are ALIE's
    identical crafted row."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, d)).astype(np.float32)
    if alie:
        honest = G[alie:]
        G[:alie] = honest.mean(0) - 1.5 * honest.std(0)
    return G


def _jkey(k):
    return jax.random.wrap_key_data(jnp.asarray(k))


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """The port on two intra-op threads, for speed: beside the other test
    workers, a machine's every core per worker spins more than it
    computes.  Each comparison here is with JAX within a band, or bit
    for bit within one process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the draws

@pytest.mark.parametrize("n", [1, 7, 1000, 79_510])
def test_threefry_bits_plain_is_the_host_s(n):
    keys = np.stack([threefry.fold_in(threefry.key(s), s + 3)
                     for s in (0, 1, 0xD0C, 2 ** 31 + 5)])
    got = R.threefry_bits(torch.from_numpy(keys.astype(np.int64)), n)
    assert got.dtype == torch.int64 and got.shape == (4, n)
    for k, row in zip(keys, got):
        np.testing.assert_array_equal(
            row.numpy(), threefry.random_bits(k, (n,)).astype(np.int64))


@pytest.mark.parametrize("n", [1, 2, 2048, 79_510, 2_700_000])
def test_permutations_are_jax_s(n):
    keys = np.stack([threefry.fold_in(threefry.key(7), i) for i in range(2)])
    assert R.shuffle_rounds(n) == {1: 0, 2: 1, 2048: 2, 79_510: 2,
                                   2_700_000: 3}[n]
    got = R.permutations(keys, n, "cpu")
    for k, row in zip(keys, got):
        np.testing.assert_array_equal(
            row.numpy(), np.asarray(jax.random.permutation(_jkey(k), n)))


def test_sketch_draw_is_jax_s_choice():
    """DnC's keys and its sketch, ``choice(k_idx, d, (r,), replace=
    False)``, for five iterations of two rounds at mnist_mlp's d."""
    d, r = 79_510, 2048
    for seed, rnd in ((0, 0), (3, 17)):
        keys = D.sketch_keys(seed, rnd, 5)
        base = jax.random.fold_in(jax.random.key(seed ^ 0xD0C),
                                  jnp.asarray(rnd, jnp.int32))
        idx, _ = D.draw_sketches(seed, rnd, 5, d, r, "cpu")
        for i in range(5):
            k_idx, k_pow = jax.random.split(jax.random.fold_in(base, i))
            np.testing.assert_array_equal(
                keys[i], np.stack([jax.random.key_data(k_idx),
                                   jax.random.key_data(k_pow)]))
            want = jax.random.choice(k_idx, d, (r,), replace=False)
            np.testing.assert_array_equal(idx[i].numpy(), np.asarray(want))
            np.testing.assert_array_equal(
                idx[i].numpy(), threefry.choice(keys[i, 0], d, r))


def test_normal_start_is_jax_s_within_the_erfinv_band():
    """The uniform is JAX's bit for bit; torch's erfinv differs from
    XLA's in the last bits, most where it is steep (|x| > 3): within
    2e-5 relative plus 1e-6."""
    keys = D.sketch_keys(5, 2, 5)[:, 1]
    got = R.normals(keys, 2048, "cpu")
    assert got.dtype == torch.float32
    for k, row in zip(keys, got):
        want = np.asarray(jax.random.normal(_jkey(k), (2048,)))
        np.testing.assert_allclose(row.numpy(), want, rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(row.numpy(), threefry.normal(k, (2048,)),
                                   rtol=0, atol=0)


# ---------------------------------------------------------------------------
# DnC against the JAX function

def _jax_scores(G, seed, rnd, i, r):
    """Iteration i's scores the JAX way (its sketch, its power
    iteration), as float64 numpy."""
    base = jax.random.fold_in(jax.random.key(seed ^ 0xD0C),
                              jnp.asarray(rnd, jnp.int32))
    k_idx, k_pow = jax.random.split(jax.random.fold_in(base, i))
    Gj = jnp.asarray(G)
    S = Gj if r == G.shape[1] else Gj[:, jax.random.choice(
        k_idx, G.shape[1], (r,), replace=False)]
    Sc = S - jnp.mean(S, axis=0)[None, :]
    v = jdnc._top_direction(Sc, k_pow)
    return np.asarray((Sc @ v) ** 2, np.float64)


def _port_scores(G, seed, rnd, n_iters, r):
    sc, _ = D.iteration_scores(torch.from_numpy(G), n_iters, r, seed, rnd)
    return [row.double().numpy() for row in sc]


_DNC_CASES = [  # (label, n, d, f, alie rows, sketch_dim)
    ("r<d", 19, 5000, 4, 0, 2048),
    ("r<d-alie-ties", 19, 5000, 4, 4, 2048),
    ("r=d", 12, 300, 3, 0, 2048),
    ("r=d-alie-ties", 12, 300, 3, 3, 2048),
    ("small-sketch", 10, 4096, 2, 0, 64),
]


@pytest.mark.parametrize("label,n,d,f,alie,sketch", _DNC_CASES,
                         ids=[c[0] for c in _DNC_CASES])
def test_dnc_matches_jax_s(label, n, d, f, alie, sketch):
    """Survivors exactly JAX's; per-iteration scores within 1e-4 of the
    largest score (the erfinv start and f32 sums in other orders); each
    keep set exact wherever the gap at its boundary exceeds that band.
    ALIE's identical rows score exactly alike in both, and both keep the
    lower indices."""
    r = min(sketch, d)
    iters = 1 if r == d else 5
    remove = min(int(1.5 * f), n - 1)
    keep = n - remove
    for seed, rnd in ((0, 0), (1, 4), (9, 11)):
        G = grads(n, d, seed, alie)
        kw = dict(sketch_dim=sketch, seed=seed, round=rnd)
        agg, tele = jdnc.dnc(jnp.asarray(G), n, f, telemetry=True, **kw)
        got = D.survivor_mask(torch.from_numpy(G), f, **kw)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(tele["survivor_mask"]).astype(bool))
        out = D.dnc(torch.from_numpy(G), n, f, **kw)
        np.testing.assert_allclose(out.numpy(), np.asarray(agg), rtol=0,
                                   atol=8 * EPS * np.abs(G).max())
        for i, ps in enumerate(_port_scores(G, seed, rnd, iters, r)):
            js = _jax_scores(G, seed, rnd, i, r)
            band = 1e-4 * js.max()
            np.testing.assert_allclose(ps, js, rtol=0, atol=band)
            srt = np.sort(js)
            if srt[keep] - srt[keep - 1] > 2 * band:
                want = np.zeros(n, bool)
                want[np.argsort(js, kind="stable")[:keep]] = True
                np.testing.assert_array_equal(
                    D.keep_sets(torch.from_numpy(ps), keep).numpy(), want)
            if alie:
                assert len(set(ps[:alie].tolist())) == 1


def test_dnc_f0_is_the_exact_mean_and_needs_no_draw():
    G = grads(10, 4096, 3)
    out = D.dnc(torch.from_numpy(G), 10, 0)
    np.testing.assert_array_equal(out.numpy(),
                                  torch.from_numpy(G).mean(0).numpy())
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jdnc.dnc(jnp.asarray(G), 10, 0)),
                               rtol=0, atol=4 * EPS)
    assert bool(D.survivor_mask(torch.from_numpy(G), 0).all())


def test_dnc_empty_survivor_set_falls_back_to_the_mean():
    """At n = 8, f = 3 five keep sets of 4 often share no client: the
    aggregate is then the overall mean, in both."""
    empty = 0
    for seed in range(12):
        G = grads(8, 4096, seed)
        jagg, tele = jdnc.dnc(jnp.asarray(G), 8, 3, round=seed,
                              telemetry=True)
        got = D.survivor_mask(torch.from_numpy(G), 3, round=seed)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(tele["survivor_mask"]).astype(bool))
        out = D.dnc(torch.from_numpy(G), 8, 3, round=seed).numpy()
        np.testing.assert_allclose(out, np.asarray(jagg), rtol=0,
                                   atol=8 * EPS * np.abs(G).max())
        if not got.any():
            empty += 1
            np.testing.assert_array_equal(
                out, torch.from_numpy(G).mean(0).numpy())
    assert empty >= 1


def test_dnc_fresh_sketches_per_round():
    G = torch.from_numpy(grads(10, 4096, 2))
    a, b = D.dnc(G, 10, 2, round=0), D.dnc(G, 10, 2, round=1)
    assert not torch.equal(a, b)
    assert torch.equal(a, D.dnc(G, 10, 2, round=0))


# ---------------------------------------------------------------------------
# GeoMedian, CenteredClip, NormBound, FLTrust against the JAX functions

@pytest.mark.parametrize("n", [10, 11])
def test_normbound_matches_jax_s_at_even_and_odd_n(n):
    """The bound is jnp.median's midpoint of the two middle norms at even
    n (torch.median would take the lower one)."""
    G = grads(n, 300, n)
    G[0] *= 50.0
    norms = torch.linalg.vector_norm(torch.from_numpy(G), dim=1)
    srt = torch.sort(norms).values
    want_bound = (srt[(n - 1) // 2] + srt[n // 2]) * 0.5
    if n % 2 == 0:
        assert want_bound != torch.median(norms)
    np.testing.assert_allclose(
        float(want_bound), float(jnp.median(jnp.linalg.norm(
            jnp.asarray(G), axis=1))), rtol=2 * EPS)
    got = norm_bounded_mean(torch.from_numpy(G), n, 2).numpy()
    want = np.asarray(jax_normbound(jnp.asarray(G), n, 2))
    np.testing.assert_allclose(got, want, rtol=0, atol=8 * EPS * 50)


@pytest.mark.parametrize("iters,eps", [(10, 1e-6), (3, 1e-2)])
def test_geomed_matches_jax_s(iters, eps):
    G = grads(15, 2000, 4)
    G[:3] += 20.0
    got = geometric_median(torch.from_numpy(G), 15, 3, iters=iters,
                           eps=eps).numpy()
    want = np.asarray(jax_geomed(jnp.asarray(G), 15, 3, iters=iters,
                                 eps=eps))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_geomed_distances_come_from_the_difference():
    """Near the median the expansion ||g||^2 - 2 g.z + ||z||^2 cancels: on
    rows 1e3 from the origin and 1e-2 apart (about 160 f32 ulp) the
    Weiszfeld weights need the difference's norm.  Both stay within 16
    ulp of 1e3 of each other and of an fp64 Weiszfeld run."""
    rng = np.random.default_rng(0)
    G = (1e3 + 1e-2 * rng.standard_normal((9, 512))).astype(np.float32)
    got = geometric_median(torch.from_numpy(G), 9, 2).numpy()
    want = np.asarray(jax_geomed(jnp.asarray(G), 9, 2))
    G64 = G.astype(np.float64)
    z = G64.mean(0)
    for _ in range(10):
        w = 1.0 / np.maximum(np.linalg.norm(G64 - z, axis=1), 1e-6)
        z = (w @ G64) / w.sum()
    ulp = float(np.spacing(np.float32(1e3)))
    np.testing.assert_allclose(got, want, rtol=0, atol=16 * ulp)
    np.testing.assert_allclose(got, z, rtol=0, atol=16 * ulp)


def test_cclip_matches_jax_s_and_large_tau_is_the_mean():
    G = grads(12, 400, 9)
    G[0] = 1e4
    for tau, iters in ((10.0, 5), (1.0, 2)):
        got = centered_clip(torch.from_numpy(G), 12, 1, tau=tau,
                            iters=iters).numpy()
        want = np.asarray(jax_cclip(jnp.asarray(G), 12, 1, tau=tau,
                                    iters=iters))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    G = grads(10, 32, 8)
    big = centered_clip(torch.from_numpy(G), 10, 2, tau=1e9).numpy()
    np.testing.assert_allclose(big, G.mean(axis=0), atol=1e-5)
    np.testing.assert_allclose(
        big, np.asarray(jax_cclip(jnp.asarray(G), 10, 2, tau=1e9)),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_fltrust_matches_jax_s_promotions(wire):
    """On a bf16 wire JAX's function keeps the rows bf16: a bf16 row norm
    (bit for bit here: XLA squares in f32, sums in f32 and rounds the sum,
    then the root, to bf16), f32 trust weights, an f32 aggregate."""
    # Honest rows around the server's direction, two rows against it.
    g0 = np.random.default_rng(5).standard_normal(3000).astype(np.float32)
    G = g0 + grads(10, 3000, 1)
    G[:2] *= -1.0
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[wire]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[wire]
    Gt, Gj = torch.from_numpy(G).to(tdt), jnp.asarray(G).astype(jdt)
    norms = row_norms(Gt, 1)
    jnorms = jnp.linalg.norm(Gj, axis=1)
    assert norms.dtype == tdt and jnorms.dtype == jdt
    np.testing.assert_allclose(norms.float().numpy(),
                               np.asarray(jnorms.astype(jnp.float32)),
                               rtol=0 if wire == "bfloat16" else 4 * EPS)
    got = fltrust(Gt, 10, 2, server_grad=torch.from_numpy(g0))
    want, tele = jax_fltrust(Gj, 10, 2, server_grad=jnp.asarray(g0),
                             telemetry=True)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    # Decisive trust: the two flipped rows get none in both.
    assert float(np.asarray(tele["trust_scores"])[:2].max()) == 0.0
    with pytest.raises(ValueError, match="requires the server gradient"):
        fltrust(Gt, 10, 2)


def test_the_five_are_registered_with_their_seams():
    for name in NEW:
        assert name in DEFENSES and name in C.DEFENSE_NAMES
    assert DEFENSES["DnC"].needs_round is True
    assert DEFENSES["FLTrust"].needs_server_grad is True


# ---------------------------------------------------------------------------
# config, CLI and refusals

_FIELDS = ("dnc_iters", "dnc_sketch_dim", "dnc_filter_frac", "geomed_iters",
           "geomed_eps", "cclip_tau", "cclip_iters")


def test_config_fields_and_defaults_are_jax_s():
    a, b = JConfig(), ExperimentConfig()
    for name in _FIELDS:
        assert getattr(a, name) == getattr(b, name), name


@pytest.mark.parametrize("kw", [
    dict(dnc_iters=0), dict(dnc_sketch_dim=0), dict(dnc_filter_frac=0.0),
    dict(cclip_iters=0), dict(cclip_tau=0.0), dict(geomed_iters=0),
    dict(geomed_eps=0.0)])
def test_config_messages_are_jax_s(kw):
    with pytest.raises(ValueError) as je:
        JConfig(**kw)
    with pytest.raises(ValueError) as te:
        ExperimentConfig(**kw)
    assert str(te.value) == str(je.value)


def test_cli_defense_flags_are_jax_s():
    def actions(parser):
        return {a.dest: (a.option_strings, a.default, a.choices, a.metavar,
                         a.type if a.type in (int, float) else None, a.help)
                for a in parser._actions
                if a.dest in _FIELDS + ("defense",)}

    got = actions(cli.build_parser())
    assert set(got) == set(_FIELDS) | {"defense"}
    assert got == actions(jax_cli.build_parser())


@pytest.mark.parametrize("argv", [
    ["-d", "DnC", "--dnc-iters", "3", "--dnc-sketch-dim", "512",
     "--dnc-filter-frac", "1.0"],
    ["-d", "GeoMedian", "--geomed-iters", "4", "--geomed-eps", "1e-4"],
    ["-d", "CenteredClip", "--cclip-tau", "2.5", "--cclip-iters", "7"],
    ["-d", "FLTrust"], ["-d", "NormBound"]])
def test_cli_builds_jax_s_config(argv):
    got = cli.config_from_args(cli.build_parser().parse_args(argv))
    want = jax_cli.config_from_args(jax_cli.build_parser().parse_args(argv))
    for name in _FIELDS + ("defense",):
        assert getattr(got, name) == getattr(want, name), name


@pytest.fixture(scope="module")
def datasets():
    return (jax_load_dataset(JC.SYNTH_MNIST_HARD, seed=0, **SIZES),
            load_dataset(C.SYNTH_MNIST_HARD, seed=0, **SIZES))


@pytest.mark.parametrize("defense", NEW)
@pytest.mark.parametrize("kind", ["faults", "async"])
def test_faults_and_async_refuse_the_five_as_jax_does(defense, kind,
                                                      datasets):
    kw = dict(dataset=C.SYNTH_MNIST_HARD, users_count=N, mal_prop=MAL_PROP,
              batch_size=B, epochs=1, defense=defense, **SIZES)
    if kind == "faults":
        jkw = dict(faults=JFaultConfig(dropout=0.1))
        tkw = dict(faults=FaultConfig(dropout=0.1))
    else:
        jkw = tkw = dict(aggregation="async", async_buffer=10)
    with pytest.raises(ValueError) as je:
        JExperiment(JConfig(**kw, **jkw), attacker=JDrift(1.5),
                    dataset=datasets[0])
    with pytest.raises(ValueError) as te:
        FederatedExperiment(ExperimentConfig(**kw, **tkw), DriftAttack(1.5),
                            datasets[1], device="cpu")
    assert str(te.value) == str(je.value)
    assert "mask-aware defense" in str(te.value)


# ---------------------------------------------------------------------------
# three rounds through the engines

def _pair(datasets, defense, **kw):
    base = dict(dataset=C.SYNTH_MNIST_HARD, users_count=N,
                mal_prop=MAL_PROP, batch_size=B, epochs=ROUNDS,
                defense=defense, **SIZES, **kw)
    jexp = JExperiment(JConfig(**base, aggregation_impl="xla"),
                       attacker=JDrift(1.5), dataset=datasets[0])
    texp = FederatedExperiment(ExperimentConfig(**base), DriftAttack(1.5),
                               datasets[1], device="cpu")
    params = jax.tree.map(np.asarray, jexp.flat.unravel(jexp.state.weights))
    texp.state = init_server_state(from_jax_params(params))
    return jexp, texp


# The bf16 wire's run is held by relative L2 at 5e-4.  The two
# frameworks' f32 gradients round to bf16 one ulp apart in a few elements
# (tests/test_torch_port_bf16.py), and FLTrust rescales each row by
# ||g0|| over its bf16 norm, whose ulp is 2^-8 to 2^-7 of it: an element
# one ulp apart can carry a row's norm across a bf16 rounding boundary
# and rescale the whole row by that much (measured 2.2e-5 after one
# round, 1.3e-4 after three).  Each round also holds the port's FLTrust
# to JAX's function on the port's own wire and server gradient, where
# the two agree to f32 summation order.
_RUNS = [(d, {}) for d in NEW] + [
    ("DnC", dict(dnc_sketch_dim=256, dnc_iters=3, dnc_filter_frac=1.0)),
    ("DnC", dict(participation=0.6)),
    ("GeoMedian", dict(geomed_iters=4, geomed_eps=1e-3)),
    ("CenteredClip", dict(cclip_tau=0.5, cclip_iters=3)),
    ("FLTrust", dict(partition="femnist_style")),
    ("FLTrust", dict(grad_dtype="bfloat16")),
]


@pytest.mark.parametrize(
    "defense,kw", _RUNS,
    ids=[d + "".join(f"-{k}={v}" for k, v in kw.items()) for d, kw in _RUNS])
def test_three_rounds_match_the_jax_engine(defense, kw, datasets):
    jexp, texp = _pair(datasets, defense, **kw)
    if defense == "FLTrust":
        # The same metadata pool, byte for byte, on the engine's device.
        np.testing.assert_array_equal(texp._meta_x.numpy(),
                                      np.asarray(jexp._meta_x))
        np.testing.assert_array_equal(texp._meta_y.numpy(),
                                      np.asarray(jexp._meta_y))
        assert len(texp.metadata[1]) >= N
    survivors, same_input = [], []
    if defense == "FLTrust":
        inner = texp.defense_fn

        def spy(G, n, f, **k):
            out = inner(G, n, f, **k)
            Gj = jnp.asarray(G.float().numpy()).astype(
                jnp.bfloat16 if G.dtype == torch.bfloat16 else jnp.float32)
            want = jax_fltrust(Gj, n, f, server_grad=jnp.asarray(
                k["server_grad"].numpy()))
            same_input.append(float(np.abs(out.numpy()
                                           - np.asarray(want)).max()))
            return out

        texp.defense_fn = spy
    if defense == "DnC":
        inner = texp.defense_fn

        def spy(G, n, f, **k):
            assert k["round"] == len(survivors)
            survivors.append(D.survivor_mask(
                G.float(), f, n_iters=texp.cfg.dnc_iters,
                filter_frac=texp.cfg.dnc_filter_frac,
                sketch_dim=texp.cfg.dnc_sketch_dim, seed=texp.cfg.seed,
                round=k["round"]))
            return inner(G, n, f, **k)

        texp.defense_fn = spy
    for t in range(ROUNDS):
        jexp.run_round(t)
        texp.run_round(t)
    if defense == "DnC":
        assert len(survivors) == ROUNDS and any(
            not bool(s.all()) for s in survivors)
    if defense == "FLTrust":
        assert len(same_input) == ROUNDS and max(same_input) <= 1e-5
    if kw.get("grad_dtype") == "bfloat16":
        got = texp.state.weights.numpy()
        want = np.asarray(jexp.state.weights)
        assert np.linalg.norm(got - want) <= 5e-4 * np.linalg.norm(want)
        return
    # Same inputs, the same arithmetic in f32 summed in other orders:
    # three momentum steps keep it far below 1e-5 a weight.
    np.testing.assert_allclose(texp.state.weights.numpy(),
                               np.asarray(jexp.state.weights), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(texp.state.velocity.numpy(),
                               np.asarray(jexp.state.velocity), rtol=0,
                               atol=1e-5)
