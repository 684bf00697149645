"""The bf16 wire and the bf16 operand route of kernels 1 and 2.

- The plain versions of the distance and Krum-score kernels on a bf16
  matrix against the JAX package's ``pallas_pairwise_distances`` on the
  same bf16 matrix in interpret mode (its bf16 tile product with f32
  accumulation and f32 norms), and its XLA ``_krum_scores`` of that
  matrix, in the d^2 band of chip_smoke.py: a squared distance summed in
  a chain of L roundings strays by about eps sqrt(L) (sq_i + sq_j), four
  times that allowed for each side.  JAX gives identical bf16 rows no
  exact zero there (its sums run in another order than the norms'), so
  they too are held in the band.
- Which kernel route each defense takes under each (grad_dtype,
  distance_dtype) pair, with the JAX package's asymmetry: unmasked Krum
  hands the wire to the fused score kernel uncast, every distance matrix
  (the guard's fallback, masked Krum, Bulyan) casts it to distance_dtype,
  f32 when unset; the coordinate-wise wrappers widen bf16 to f32.
- The crafts on a bf16 matrix against JAX's: ALIE, signflip and noise
  round where jnp's bf16 ops do (crafted rows within 1 bf16 ulp), min-max
  crafts in f32 and rounds once, the backdoor's shadow arithmetic is f32
  between bf16 clip bounds.
- Whole runs (n = 19, f = 4, three rounds) against the JAX engine on a
  bf16 wire under the five defenses and faulted TrimmedMean, and with
  distance_dtype='bfloat16' under Krum and Bulyan: NoDefense and Krum on
  its XLA path, the rest on its Pallas suite in interpret mode (the
  route the port mirrors: the XLA path computes their estimators in
  bf16).  Tolerances are stated at each check.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attacking_federate_learning_tpu import config as JC
from attacking_federate_learning_tpu.attacks import (
    DriftAttack as JDrift, GaussianNoiseAttack as JNoise,
    SignFlipAttack as JSignFlip
)
from attacking_federate_learning_tpu.attacks.minmax import (
    MinMaxAttack as JMinMax
)
from attacking_federate_learning_tpu.config import (
    ExperimentConfig as JConfig, FaultConfig as JFaultConfig
)
from attacking_federate_learning_tpu.core.engine import (
    FederatedExperiment as JExperiment
)
from attacking_federate_learning_tpu.data.datasets import (
    load_dataset as jax_load_dataset
)
from attacking_federate_learning_tpu.defenses.kernels import (
    _krum_scores as jax_krum_scores
)
from attacking_federate_learning_tpu.ops.pallas_distances import (
    pallas_pairwise_distances
)
from attacking_federate_learning_tpu_torch import config as C
from attacking_federate_learning_tpu_torch.attacks import (
    DriftAttack, GaussianNoiseAttack, SignFlipAttack
)
from attacking_federate_learning_tpu_torch.attacks.base import cohort_stats
from attacking_federate_learning_tpu_torch.attacks.minmax import (
    MinMaxAttack
)
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
from attacking_federate_learning_tpu_torch.defenses import kernels as K
from attacking_federate_learning_tpu_torch.ops import defense_kernels as DK
from attacking_federate_learning_tpu_torch.ops.distances import (
    gram_route, pairwise_distances, pairwise_distances_plain
)
from attacking_federate_learning_tpu_torch.utils.weights import (
    from_jax_params
)

EPS = float(np.finfo(np.float32).eps)
SIZES = dict(synth_train=1200, synth_test=300)
N, MAL_PROP, B, ROUNDS = 19, 0.22, 32, 3


def _bf16_cohort(n, d, f, seed):
    """Seeded (n, d) bf16 ALIE-like cohort: the first f rows identical."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, d), dtype=np.float32)
    G[:f] = G[f:].mean(0) - 1.5 * G[f:].std(0)
    return torch.from_numpy(G).bfloat16()


def _band(Gb, chain):
    """4 sqrt(chain) eps (sq_i + sq_j) of the bf16 values, in fp64."""
    G64 = Gb.double()
    sq = (G64 * G64).sum(1)
    return 4.0 * np.sqrt(chain) * EPS * (sq[:, None] + sq[None, :])


@pytest.mark.parametrize("n,d,f", [(13, 700, 3), (20, 4099, 5),
                                   (7, 79, 2), (33, 2050, 8)])
def test_plain_distances_on_bf16_match_the_pallas_bf16_route(n, d, f):
    Gb = _bf16_cohort(n, d, f, n + d)
    got = pairwise_distances(Gb)          # the CPU takes the plain version
    assert got.dtype == torch.float32
    assert torch.equal(got, pairwise_distances_plain(Gb.float()))
    want = np.asarray(pallas_pairwise_distances(
        jnp.asarray(Gb.float().numpy()).astype(jnp.bfloat16),
        interpret=True))
    # Both sides sum d products in one chain each (the Pallas kernel in
    # blocks of 512 k, the plain version in one matmul).
    band = 2 * _band(Gb, d).numpy()
    err2 = np.abs(got.double().numpy() ** 2 - want.astype(np.float64) ** 2)
    assert (err2 <= band).all()
    assert (np.diag(want) == 0).all() and (got.diagonal() == 0).all()


@pytest.mark.parametrize("n,d,f", [(13, 700, 3), (20, 4099, 5),
                                   (33, 2050, 8)])
def test_plain_krum_scores_on_bf16_match_jax_scoring(n, d, f):
    Gb = _bf16_cohort(n, d, f, 3 * n + d)
    scores, rowsum = DK.krum_scores(Gb, f)
    want_D = pallas_pairwise_distances(
        jnp.asarray(Gb.float().numpy()).astype(jnp.bfloat16),
        interpret=True)
    want = np.asarray(jax_krum_scores(want_D, n, f, method="topk"))
    D = np.asarray(want_D).astype(np.float64)
    # A distance strays by at most min(sqrt(b), b / D) of its d^2 band b;
    # a score by its row's sum of those (rowsum and top c each), plus
    # the rounding of n-term sums in another order.
    b = 2 * _band(Gb, d).numpy()
    e = np.where(D > 0, np.minimum(np.sqrt(b), b / np.maximum(D, 1e-30)),
                 np.sqrt(b))
    np.fill_diagonal(e, 0.0)
    tol = 2 * e.sum(1) + 2 * n * EPS * np.abs(rowsum.numpy())
    assert (np.abs(scores.double().numpy() - want) <= tol).all()
    assert int(torch.argmin(scores)) < f or np.argmin(want) >= f


def _recording(monkeypatch):
    """Spies on the two Gram kernels as the defenses call them: the
    dtype of each matrix they are handed."""
    calls = []

    def spy(name, fn):
        def wrapped(G, *a, **kw):
            calls.append((name, G.dtype))
            return fn(G, *a, **kw)
        return wrapped

    monkeypatch.setattr(K, "pairwise_distances",
                        spy("pairwise_distances", K.pairwise_distances))
    monkeypatch.setattr(K, "krum_scores", spy("krum_scores", K.krum_scores))
    return calls


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("wire,dist,want", [
    # Unmasked Krum: the fused kernel on the wire uncast (or cast to
    # distance_dtype).
    (F32, None, [("krum_scores", F32)]),
    (BF16, None, [("krum_scores", BF16)]),
    (F32, "bfloat16", [("krum_scores", BF16)]),
    (BF16, "bfloat16", [("krum_scores", BF16)]),
])
def test_unmasked_krum_routes(wire, dist, want, monkeypatch):
    calls = _recording(monkeypatch)
    G = _bf16_cohort(19, 300, 4, 1).to(wire)
    K.krum(G, 19, 4, method="fused", distance_dtype=dist)
    assert calls == want


@pytest.mark.parametrize("wire,dist,want", [
    (F32, None, F32), (BF16, None, F32),
    (F32, "bfloat16", BF16), (BF16, "bfloat16", BF16)])
def test_distance_matrices_cast_to_distance_dtype(wire, dist, want,
                                                  monkeypatch):
    """Masked Krum, Bulyan, the guard's fallback and Krum at f = 0 take
    the distance kernel on distance_dtype, f32 when unset, whatever the
    wire (the JAX package's _distances_for(..., 'pallas', ...))."""
    calls = _recording(monkeypatch)
    G = _bf16_cohort(19, 300, 4, 2).to(wire)
    mask = torch.ones(19, dtype=torch.bool)
    mask[5] = False
    K.krum(G, 19, 4, method="fused", mask=mask, distance_dtype=dist)
    K.bulyan(G, 19, 4, distance_dtype=dist)
    K.krum(G, 19, 0, method="fused", distance_dtype=dist)    # c < 0
    # A cohort whose kept mass sits under the guard's floor: a row of
    # huge values makes the complement hold nearly all of every rowsum.
    H = G.clone()
    H[6] = 1e4
    K.krum(H, 19, 4, method="fused", distance_dtype=dist)
    assert calls == [("pairwise_distances", want)] * 3 + [
        ("krum_scores", BF16 if BF16 in (wire, _dt(dist)) else F32),
        ("pairwise_distances", want)]


def _dt(name):
    return {None: None, "bfloat16": BF16}[name]


def test_coordinate_wrappers_widen_bf16():
    Gb = _bf16_cohort(19, 300, 4, 3)
    Gf = Gb.float()
    mask = torch.ones(19, dtype=torch.bool)
    mask[2] = False
    assert torch.equal(DK.trimmed_mean_of(Gb, 14),
                       DK.trimmed_mean_of_plain(Gf, 14))
    assert torch.equal(DK.median_of(Gb), DK.median_of_plain(Gf))
    assert torch.equal(DK.masked_trimmed_mean(Gb, mask, 5),
                       DK.masked_trimmed_mean_plain(Gf, mask, 5))
    assert torch.equal(DK.masked_median(Gb, mask),
                       DK.masked_median_plain(Gf, mask))
    for out in (K.trimmed_mean(Gb, 19, 4), K.DEFENSES["Median"](Gb, 19, 4)):
        assert out.dtype == torch.float32
    # NoDefense keeps the wire's dtype, summed in f32 and rounded once.
    mean = K.no_defense(Gb, 19, 4)
    assert mean.dtype == BF16
    assert torch.equal(mean, Gf.mean(0).bfloat16())


def test_the_bf16_routes_have_their_own_names():
    assert gram_route("pairwise_distances", torch.zeros(2, 2, dtype=BF16)) \
        == "pairwise_distances[bf16]"
    assert gram_route("krum_scores", torch.zeros(2, 2)) == "krum_scores"


def _bits(x):
    """bf16 values as ordered integers: adjacent bf16 values differ by 1."""
    b = x.contiguous().view(torch.int16).numpy().astype(np.int32)
    return np.where(b < 0, -(b & 0x7FFF), b)


def _ulps(got, want):
    return np.abs(_bits(got) - _bits(want))


@pytest.mark.parametrize("name", ["alie", "signflip", "noise"])
def test_crafts_on_a_bf16_matrix_match_jax(name):
    rng = np.random.default_rng(7)
    G = torch.from_numpy(rng.standard_normal((19, 5000),
                                             dtype=np.float32)).bfloat16()
    jG = jnp.asarray(G.float().numpy()).astype(jnp.bfloat16)
    port, jax_ = {"alie": (DriftAttack(1.37), JDrift(1.37)),
                  "signflip": (SignFlipAttack(1.5), JSignFlip(1.5)),
                  "noise": (GaussianNoiseAttack(1.5, seed=3),
                            JNoise(1.5, seed=3))}[name]
    from attacking_federate_learning_tpu.attacks.base import (
        AttackContext as JContext
    )
    from attacking_federate_learning_tpu_torch.attacks.base import (
        AttackContext
    )
    got = port.apply(G.clone(), 4, AttackContext(None, None, 2))
    want = jax_.apply(jG, 4, JContext(None, None, jnp.int32(2)))
    assert got.dtype == BF16
    want = torch.from_numpy(np.array(want.astype(jnp.float32))).bfloat16()
    assert torch.equal(got[4:], G[4:])
    # jnp's mean and variance sum in f32 in another order than torch's
    # before one rounding to bf16, so a statistic may land 1 ulp apart,
    # and the crafted row with it; never more.
    u = _ulps(got[:4], want[:4])
    assert u.max() <= 1 and u.mean() <= 0.01
    assert (got[:4] == got[0]).all()


def test_minmax_on_bf16_crafts_in_f32_and_rounds_once():
    rng = np.random.default_rng(8)
    G = torch.from_numpy(rng.standard_normal((19, 3000),
                                             dtype=np.float32)).bfloat16()
    got = MinMaxAttack(1.5).craft(G[:4], None)
    assert got.dtype == BF16
    assert torch.equal(got, MinMaxAttack(1.5).craft(G[:4].float(),
                                                    None).bfloat16())
    assert JMinMax(1.5).craft(jnp.asarray(G[:4].float().numpy()).astype(
        jnp.bfloat16), None).dtype == jnp.bfloat16


def test_backdoor_craft_on_a_bf16_matrix_matches_jax(datasets):
    """The clipped backdoor on a bf16 cohort: bf16 clip bounds, f32
    shadow training (JAX promotes the bf16 mean against the f32 weights
    and lr), and the f32 craft rounded into the bf16 wire's rows."""
    from attacking_federate_learning_tpu.attacks.backdoor import (
        BackdoorAttack as JBackdoor
    )
    from attacking_federate_learning_tpu_torch.attacks.backdoor import (
        BackdoorAttack
    )
    from attacking_federate_learning_tpu_torch.attacks.base import (
        AttackContext
    )

    cfg = dict(dataset=C.SYNTH_MNIST_HARD, users_count=N,
               mal_prop=MAL_PROP, batch_size=B, mal_batch_size=64,
               backdoor="1", **SIZES)
    ja = JBackdoor(JConfig(**cfg, aggregation_impl="xla"), datasets[0])
    ta = BackdoorAttack(ExperimentConfig(**cfg), datasets[1], device="cpu")
    jexp = JExperiment(JConfig(**cfg), dataset=datasets[0])
    w = np.asarray(jexp.state.weights)
    params = jax.tree.map(np.asarray, jexp.flat.unravel(jexp.state.weights))
    rng = np.random.default_rng(1)
    G = torch.from_numpy(rng.standard_normal((4, w.shape[0]),
                                             dtype=np.float32) * 0.01)
    G = G.bfloat16()
    lr = np.float32(1000.0) / np.float32(10002.0)
    jG = jnp.asarray(G.float().numpy()).astype(jnp.bfloat16)
    want = ja._craft(jG, jnp.asarray(w), jnp.asarray(lr))
    assert want.dtype == jnp.float32
    got = ta.craft(G, AttackContext(from_jax_params(params),
                                    torch.tensor(lr), 2))
    assert got.dtype == torch.float32
    # Into the wire: the two f32 crafts drift up to 5e-7 apart over the
    # shadow steps (tests/test_torch_port_backdoor.py), so their bf16
    # casts agree within 1 ulp, or within that drift where an element is
    # small enough for it to span more ulps.
    want = torch.from_numpy(np.array(want))
    u = torch.from_numpy(_ulps(got.bfloat16(), want.bfloat16()))
    assert (u > 0).double().mean() <= 1e-3
    far = u > 1
    assert ((got - want).abs()[far] <= 5e-7).all()
    # Clipped to the bounds of bf16 arithmetic.
    mean, sd = cohort_stats(G)
    assert mean.dtype == sd.dtype == BF16
    lo, hi = (mean - 1.5 * sd).float(), (mean + 1.5 * sd).float()
    assert ((got >= lo) & (got <= hi)).all()


@pytest.fixture(scope="module")
def datasets():
    return (jax_load_dataset(JC.SYNTH_MNIST_HARD, seed=0, **SIZES),
            load_dataset(C.SYNTH_MNIST_HARD, seed=0, **SIZES))


def _pair(defense, impl, datasets, faults=None, **extra):
    kw = dict(dataset=C.SYNTH_MNIST_HARD, users_count=N, mal_prop=MAL_PROP,
              batch_size=B, epochs=ROUNDS, defense=defense, **SIZES, **extra)
    jexp = JExperiment(JConfig(**kw, aggregation_impl=impl,
                               log_round_stats=defense == "Krum",
                               telemetry=faults is not None,
                               faults=faults and JFaultConfig(**faults)),
                       attacker=JDrift(1.5), dataset=datasets[0])
    texp = FederatedExperiment(
        ExperimentConfig(**kw, faults=faults and FaultConfig(**faults)),
        DriftAttack(1.5), datasets[1], device="cpu")
    params = jax.tree.map(np.asarray, jexp.flat.unravel(jexp.state.weights))
    texp.state = init_server_state(from_jax_params(params))
    return jexp, texp


_FAULTS = dict(dropout=0.15, corrupt=0.1)
# (defense, JAX path, faults, config, rel. L2 tolerance of the weights).
_RUNS = [
    ("NoDefense", "xla", None, dict(grad_dtype="bfloat16"), 3e-5),
    ("Krum", "xla", None, dict(grad_dtype="bfloat16"), 3e-5),
    ("TrimmedMean", "pallas", None, dict(grad_dtype="bfloat16"), 3e-4),
    ("Median", "pallas", None, dict(grad_dtype="bfloat16"), 3e-5),
    ("Bulyan", "pallas", None, dict(grad_dtype="bfloat16"), 3e-5),
    ("TrimmedMean", "pallas", _FAULTS, dict(grad_dtype="bfloat16"), 3e-4),
    ("Krum", "xla", None, dict(distance_dtype="bfloat16"), 3e-5),
    ("Bulyan", "pallas", None, dict(distance_dtype="bfloat16"), 3e-5),
]


@pytest.mark.parametrize(
    "defense,impl,faults,extra,tol", _RUNS,
    ids=[f"{d}-{'wire' if 'grad_dtype' in e else 'distances'}"
         + ("-faulted" if fl else "") for d, _, fl, e, _ in _RUNS])
def test_three_bf16_rounds_match_the_jax_engine(defense, impl, faults, extra,
                                                tol, datasets):
    jexp, texp = _pair(defense, impl, datasets, faults, **extra)
    bf16_wire = extra.get("grad_dtype") == "bfloat16"
    winners = []
    if defense == "Krum":
        inner = texp.defense_fn

        def spy(grads, n, f, **kw):
            out = inner(grads, n, f, **kw)
            winners.append(np.flatnonzero((grads == out).all(1).numpy()))
            return out

        texp.defense_fn = spy
    if bf16_wire:
        # The wire at the same weights: both sides compute f32 gradients
        # about 1e-7 of their row apart, so the cast lands 1 bf16 ulp
        # apart in a few elements, and more than 1 ulp only where an
        # element is small next to its row (its two f32 values differ by
        # many of its own ulps).  Measured: 0.033 % of elements off, 12
        # of 1.5 million by more than 1 ulp, all below 1e-4 of their row.
        jg = jexp._compute_grads_impl(jexp.state, jnp.int32(0))
        jg = torch.from_numpy(np.array(jg.astype(jnp.float32)))
        tg = texp.compute_grads(0)
        assert tg.dtype == BF16
        u = torch.from_numpy(_ulps(tg, jg.bfloat16()))
        assert (u > 0).double().mean() <= 1e-3
        assert (u > 1).double().mean() <= 1e-4
        small = 1e-3 * jg.abs().amax(1, keepdim=True).expand_as(jg)
        assert (jg.abs()[u > 1] <= small[u > 1]).all()
    for t in range(ROUNDS):
        jexp.run_round(t)
        texp.run_round(t)
        if defense == "Krum":
            # The JAX winner is one of the rows equal to the port's
            # aggregate (ALIE's crafted rows are identical copies).
            assert int(jexp.last_round_stats["krum_selected"]) in winners[t]
        if faults:
            want = {k[len("fault_"):]: int(v) for k, v in
                    jexp.last_round_telemetry.items()
                    if k.startswith("fault_")}
            got = {k: int(v) for k, v in texp.last_round_faults.items()
                   if k != "round"}
            assert got == want
    # The final weights, relative L2: a wire element 1 bf16 ulp apart
    # moves a mean by 2^-8 of that element over m, a selection not at all
    # unless it decides; measured 3e-6 to 9e-6.  TrimmedMean keeps the
    # values nearest the median, and bf16 values tie or nearly tie often,
    # so a value 1 ulp apart can trade places with one many ulps away at
    # the trim's edge: 3e-4 there (measured 1.2e-5 to 5.7e-5).
    want = np.asarray(jexp.state.weights)
    got = texp.state.weights.numpy()
    assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want)
