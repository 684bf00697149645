"""The port's attack layer vs the JAX package's attacks/.

- ALIE with a context, signflip, Gaussian noise, min-max and min-sum (all
  three directions) on seeded numpy cohorts, each craft held against the
  JAX attack's craft on the same rows, with the tolerance stated where it
  is asserted.
- ``threefry.normal``: the uniform step bit for bit ``jax.random``'s, the
  normal within a stated band of ``jax.random.normal`` and within one ulp
  of an fp64 inverse error function of the same uniforms.
- The registry's names, its unknown-name error and ``make_attacker``'s
  choice; the config's attack fields, defaults, coercion and errors; the
  CLI's ``-b`` / ``--attack`` flags and errors: the JAX package's, word
  for word.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attacking_federate_learning_tpu import attacks as JA
from attacking_federate_learning_tpu import cli as jax_cli
from attacking_federate_learning_tpu.attacks import minmax as JM
from attacking_federate_learning_tpu.attacks.base import (
    AttackContext as JContext
)
from attacking_federate_learning_tpu.attacks.baselines import (
    GaussianNoiseAttack as JNoise, SignFlipAttack as JSignFlip
)
from attacking_federate_learning_tpu.config import ExperimentConfig as JConfig
from attacking_federate_learning_tpu.core.server import faded_learning_rate
from attacking_federate_learning_tpu_torch import attacks as A
from attacking_federate_learning_tpu_torch import cli
from attacking_federate_learning_tpu_torch import config as C
from attacking_federate_learning_tpu_torch.attacks import (
    AttackContext, DriftAttack, GaussianNoiseAttack, MinMaxAttack,
    MinSumAttack, SignFlipAttack
)
from attacking_federate_learning_tpu_torch.attacks import minmax as M
from attacking_federate_learning_tpu_torch.config import ExperimentConfig
from attacking_federate_learning_tpu_torch.core.engine import (
    FederatedExperiment
)
from attacking_federate_learning_tpu_torch.data.datasets import load_dataset
from attacking_federate_learning_tpu_torch.utils import threefry

EPS = float(np.finfo(np.float32).eps)
# (f, d, seed) of the crafting cohorts: the flat round's f = 4 at n = 19,
# the chip's f = 24, and a ragged width.
COHORTS = [(4, 4_099, 0), (24, 2_000, 1), (7, 513, 2)]


def _cohort(f, d, seed):
    rng = np.random.default_rng(seed)
    # Gradient-like scale: small, with a per-coordinate spread.
    scale = rng.uniform(1e-3, 3e-2, d).astype(np.float32)
    return (rng.standard_normal((f, d), dtype=np.float32) * scale
            + rng.standard_normal(d, dtype=np.float32) * 1e-2)


def _ctx(t=0, d=1):
    """A port context and a JAX one for round t (weights unused here)."""
    return (AttackContext(torch.zeros(d), torch.tensor(0.1), t),
            JContext(jnp.zeros(d), jnp.float32(0.1), jnp.int32(t)))


def _mean_band(G):
    """Summation-order band of a cohort mean: f rounding steps of the
    largest |g| (the frameworks reduce in other orders)."""
    return G.shape[0] * EPS * float(np.abs(G).max())


@pytest.mark.parametrize("f,d,seed", COHORTS)
def test_alie_with_a_context_matches_jax(f, d, seed):
    G = _cohort(f, d, seed)
    tctx, jctx = _ctx(3, d)
    got = DriftAttack(1.5).craft(torch.from_numpy(G), tctx).numpy()
    want = np.asarray(JA.DriftAttack(1.5).craft(jnp.asarray(G), jctx))
    # mean - 1.5 sigma: the mean's band plus 1.5 times the std's (a
    # square root of a summed square: relative f*eps of sigma).
    tol = _mean_band(G) + 1.5 * f * EPS * float(G.std(0).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert np.array_equal(
        got, DriftAttack(1.5).craft(torch.from_numpy(G)).numpy())


@pytest.mark.parametrize("f,d,seed", COHORTS)
@pytest.mark.parametrize("z", [1.0, 1.5])
def test_signflip_matches_jax(f, d, seed, z):
    G = _cohort(f, d, seed)
    tctx, jctx = _ctx(0, d)
    got = SignFlipAttack(z).craft(torch.from_numpy(G), tctx).numpy()
    want = np.asarray(JSignFlip(z).craft(jnp.asarray(G), jctx))
    np.testing.assert_allclose(got, want, rtol=0, atol=z * _mean_band(G))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 3])
@pytest.mark.parametrize("t", [0, 1, 17, 299])
def test_threefry_normal_matches_jax(seed, t):
    d = 20_000
    k = threefry.fold_in(threefry.key(seed), t)
    jk = jax.random.fold_in(jax.random.key(seed), jnp.asarray(t, jnp.int32))
    f32 = np.float32
    lo = np.nextafter(f32(-1.0), f32(0.0), dtype=f32)
    # The uniform step on [lo, 1): bit for bit JAX's.
    u = np.maximum(lo, threefry.uniform(k, (d,)) * (f32(1.0) - lo) + lo)
    ju = np.asarray(jax.random.uniform(jk, (d,), jnp.float32, lo, 1.0))
    np.testing.assert_array_equal(u.view(np.uint32), ju.view(np.uint32))
    got = threefry.normal(k, (d,))
    want = np.asarray(jax.random.normal(jk, (d,), jnp.float32))
    assert got.dtype == np.float32 and got.shape == (d,)
    # torch's erfinv is within one ulp of an fp64 erfinv of the same u.
    exact = (np.sqrt(2.0) * torch.erfinv(
        torch.from_numpy(u.astype(np.float64))).numpy()).astype(np.float32)
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - exact.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    # XLA's erf_inv is a polynomial that strays from the exact value by
    # up to ~100 ulp in the tails.  Measured over 36 draws of 79,510
    # (seeds 0-3, 7, 2**31 + 3; rounds 0, 1, 5, 6, 17, 299): at most 5 ulp
    # apart for |x| < 2, 91 ulp at |x| = 3.76, relative 5.8e-6 anywhere.
    core = np.abs(want) < 2.0
    jul = np.abs(got.view(np.int32).astype(np.int64)
                 - want.view(np.int32).astype(np.int64))
    assert jul[core].max() <= 6
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("f,d,seed", COHORTS)
@pytest.mark.parametrize("t", [0, 5])
def test_noise_matches_jax(f, d, seed, t):
    G = _cohort(f, d, seed)
    tctx, jctx = _ctx(t, d)
    att = GaussianNoiseAttack(1.5, seed=seed)
    got = att.craft(torch.from_numpy(G), tctx).numpy()
    want = np.asarray(JNoise(1.5, seed=seed).craft(jnp.asarray(G), jctx))
    noise = att.noise(t, d).numpy()
    sigma = G.std(0)
    # mean + 1.5 sigma * noise: the mean's band, sigma's relative f*eps,
    # and the noise's relative 1e-5 (test_threefry_normal_matches_jax).
    tol = (_mean_band(G)
           + 1.5 * sigma * np.abs(noise) * (f * EPS + 1e-5) + EPS)
    assert (np.abs(got - want) <= tol).all()
    # Rounds draw other noise; no context is round 0.
    other = att.craft(torch.from_numpy(G), _ctx(t + 1, d)[0]).numpy()
    assert not np.array_equal(other, got)
    assert np.array_equal(att.craft(torch.from_numpy(G)).numpy(),
                          att.craft(torch.from_numpy(G), _ctx(0, d)[0])
                          .numpy())


def _jax_gamma(cls, G, direction):
    """The JAX attack's gamma, from its own functions."""
    att = cls(1.5, direction=direction)
    mean, p = JM._direction(G, direction)
    budget = att._threshold(G)
    return float(JM._bisect_gamma(
        lambda g: att._violation(mean + g * p, G) <= budget))


def _edge64(kind, G, direction):
    """The constraint's edge in fp64, and the last bisection step: the
    same 10 doublings from 10, then halvings to full fp64 resolution,
    with exact feasibility."""
    G = G.astype(np.float64)
    mean, std = G.mean(0), G.std(0)
    p = {"std": -std, "sign": -np.sign(mean),
         "unit": -mean / max(np.linalg.norm(mean), 1e-12)}[direction]
    d2 = ((G[:, None, :] - G[None, :, :]) ** 2).sum(-1)
    budget = d2.max() if kind == "minmax" else d2.sum(1).max()

    def feasible(gamma):
        c = ((G - (mean + gamma * p)) ** 2).sum(1)
        return (c.max() if kind == "minmax" else c.sum()) <= budget

    hi = 10.0
    for _ in range(10):
        hi = hi * 2.0 if feasible(hi) else hi
    step, lo = hi / 2 ** 25, 0.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if feasible(mid) else (lo, mid)
    return lo, step


@pytest.mark.parametrize("kind", ["minmax", "minsum"])
@pytest.mark.parametrize("direction", ["std", "sign", "unit"])
@pytest.mark.parametrize("f,d,seed", COHORTS)
def test_minmax_and_minsum_match_jax(kind, direction, f, d, seed):
    G = _cohort(f, d, seed)
    tcls = {"minmax": MinMaxAttack, "minsum": MinSumAttack}[kind]
    jcls = {"minmax": JM.MinMaxAttack, "minsum": JM.MinSumAttack}[kind]
    att = tcls(1.5, direction=direction)
    tctx, jctx = _ctx(0, d)
    got = att.craft(torch.from_numpy(G), tctx).numpy()
    want = np.asarray(jcls(1.5, direction=direction).craft(jnp.asarray(G),
                                                           jctx))
    gamma = float(att.last_gamma)
    assert att.last_gamma.dtype == torch.float32 and att.last_gamma.ndim == 0
    jg = _jax_gamma(jcls, jnp.asarray(G), direction)
    # gamma comes out of the same fixed bisection in both, but a
    # feasibility test at the edge compares two f32 sums that agree to a
    # few ulp, so it can flip between the frameworks and move gamma by a
    # bisection step (it does on three of these eighteen cases, all in
    # the 'std' direction).  Adjudicated in fp64: each framework's gamma
    # lies within two of its last steps of the exact edge, one for the
    # bisection and one for a flip (measured: at most 0.96 of a step).
    edge, step = _edge64(kind, G, direction)
    assert gamma > 0
    assert abs(gamma - edge) <= 2 * step and abs(jg - edge) <= 2 * step
    mean, std = G.mean(0), G.std(0)
    p = {"std": std, "sign": np.ones(d, np.float32),
         "unit": np.abs(mean) / np.linalg.norm(mean)}[direction]
    # mean + gamma * p: the mean's band plus gamma times the direction's
    # (std relative f*eps; sign exact; unit a norm of d terms, relative
    # sqrt(d)*eps), plus the adjudicated gamma difference times |p|.
    rel = {"std": f * EPS, "sign": 0.0, "unit": np.sqrt(d) * EPS}[direction]
    tol = (_mean_band(G) + gamma * p * rel + EPS * np.abs(want)
           + abs(gamma - jg) * p * (1 + EPS))
    assert (np.abs(got - want) <= tol).all()


def test_minmax_gamma_grows_and_bisects_without_a_host_read():
    """The bisection's trip counts are JAX's (10 doublings from 10, 25
    halvings): a constraint feasible everywhere ends at 10 * 2**10, one
    feasible nowhere at 0, one with a known edge within a step of it."""
    like = torch.zeros(())
    assert float(M._bisect_gamma(lambda g: g >= 0, like)) == 10 * 2 ** 10
    assert float(M._bisect_gamma(lambda g: g < 0, like)) == 0.0
    got = float(M._bisect_gamma(lambda g: g <= 37.3, like))
    step = 10 * 2 ** 6 / 2 ** 25
    assert 37.3 - step <= got <= 37.3
    assert got == float(JM._bisect_gamma(lambda g: g <= 37.3))


def test_attack_with_zero_z_or_no_attackers_leaves_the_rows():
    G = torch.from_numpy(_cohort(6, 300, 3))
    for att in (SignFlipAttack(0.0), MinMaxAttack(0.0), DriftAttack(0.0)):
        assert torch.equal(att.apply(G.clone(), 3), G)
    assert torch.equal(SignFlipAttack(1.5).apply(G.clone(), 0), G)
    out = SignFlipAttack(1.5).apply(G.clone(), 3)
    assert torch.equal(out[3:], G[3:])
    assert torch.equal(out[0], out[2])


def test_registry_names_and_errors_match_jax():
    assert A.ATTACKS.names() == sorted(JA.ATTACKS.names())
    with pytest.raises(KeyError) as te:
        A.ATTACKS["nope"]
    assert str(te.value).startswith("\"Unknown attack 'nope'; available: [")
    assert "backdoor_timed" in A.ATTACKS


@pytest.mark.parametrize("name,cls", [
    ("none", A.NoAttack), ("alie", DriftAttack), ("signflip", SignFlipAttack),
    ("noise", GaussianNoiseAttack), ("minmax", MinMaxAttack),
    ("minsum", MinSumAttack)])
def test_make_attacker_builds_the_named_attack(name, cls):
    cfg = ExperimentConfig(num_std=1.2, attack_direction="unit", seed=5)
    att = A.make_attacker(cfg, name=name, device="cpu")
    jatt = JA.make_attacker(JConfig(num_std=1.2, attack_direction="unit",
                                    seed=5), name=name)
    assert type(att) is cls and att.name == jatt.name
    assert att.num_std == jatt.num_std
    assert getattr(att, "direction", None) == getattr(jatt, "direction",
                                                      None)


def test_make_attacker_picks_backdoor_when_b_is_set():
    ds = load_dataset(C.SYNTH_MNIST_HARD, seed=0, synth_train=300,
                      synth_test=50)
    assert type(A.make_attacker(ExperimentConfig(), device="cpu")) \
        is DriftAttack
    att = A.make_attacker(ExperimentConfig(backdoor="pattern"), dataset=ds,
                          device="cpu")
    assert att.name == "backdoor" and att.poison_x.device.type == "cpu"
    # An explicit name wins over -b, as in the JAX package.
    assert type(A.make_attacker(ExperimentConfig(backdoor="pattern"),
                                name="alie", device="cpu")) is DriftAttack


_ATTACK_FIELDS = ("backdoor", "alpha", "mal_epochs", "mal_batch_size",
                  "mal_learning_rate", "mal_weight_decay", "backdoor_fused",
                  "attack_direction")


def test_config_attack_fields_and_defaults_match_jax():
    tf = {f.name: f for f in dataclasses.fields(ExperimentConfig)}
    jf = {f.name: f for f in dataclasses.fields(JConfig)}
    for name in _ATTACK_FIELDS:
        assert tf[name].default == jf[name].default, name
        assert tf[name].type == jf[name].type, name


@pytest.mark.parametrize("given,want", [
    ("No", False), (False, False), ("pattern", "pattern"), ("1", 1),
    ("3", 3), (2, 2)])
def test_config_backdoor_coercion_matches_jax(given, want):
    got = ExperimentConfig(backdoor=given).backdoor
    assert got == JConfig(backdoor=given).backdoor == want
    assert type(got) is type(want)


@pytest.mark.parametrize("kw", [
    dict(attack_direction="up"), dict(attack_direction=""),
    dict(backdoor="pattern", backdoor_fused=False),
    dict(backdoor="1", backdoor_fused=False)])
def test_config_attack_errors_are_jax_s(kw):
    # The port's defenses always take the kernel route, JAX's
    # aggregation_impl='pallas', whose refusal of the staged backdoor the
    # port keeps.
    with pytest.raises(ValueError) as je:
        JConfig(**kw, defense="Krum", aggregation_impl="pallas")
    with pytest.raises(ValueError) as te:
        ExperimentConfig(**kw, defense="Krum")
    assert str(te.value) == str(je.value)


def test_staged_flag_without_a_backdoor_is_accepted():
    assert ExperimentConfig(backdoor_fused=False).backdoor is False


def _actions(parser, dests):
    return {a.dest: (a.option_strings, a.default, a.choices)
            for a in parser._actions if a.dest in dests}


def test_cli_attack_flags_have_jax_s_names_defaults_and_choices():
    dests = ("backdoor", "attack", "attack_direction")
    assert (_actions(cli.build_parser(), dests)
            == _actions(jax_cli.build_parser(), dests))


@pytest.mark.parametrize("flags", [
    [], ["-b", "pattern"], ["-b", "2"], ["--attack", "minsum",
                                         "--attack-direction", "sign"]])
def test_cli_builds_jax_s_attack_config(flags):
    got = cli.config_from_args(cli.build_parser().parse_args(flags))
    want = jax_cli.config_from_args(jax_cli.build_parser().parse_args(flags))
    for name in _ATTACK_FIELDS:
        assert getattr(got, name) == getattr(want, name), name


def _cli_error(main, argv, capsys):
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2
    return capsys.readouterr().err.strip().splitlines()[-1]


@pytest.mark.parametrize("argv", [
    ["--attack", "backdoor"], ["--attack", "backdoor_timed"],
    ["-b", "pattern", "--attack", "backdoor_timed"]])
def test_cli_attack_errors_are_jax_s(argv, capsys):
    want = _cli_error(jax_cli.main, argv, capsys)
    got = _cli_error(cli.main, argv, capsys)
    assert got.split(": error: ", 1)[1] == want.split(": error: ", 1)[1]


@pytest.mark.parametrize("attack", ["signflip", "noise", "minmax",
                                    "minsum"])
def test_cli_runs_each_attack_on_the_cpu(attack, capsys, tmp_path):
    result = cli.main(["-s", C.SYNTH_MNIST_HARD, "-n", "7", "-m", "0.3",
                       "-e", "2", "-c", "8", "--attack", attack,
                       "-d", "TrimmedMean", "--synth-train", "100",
                       "--synth-test", "20", "--device", "cpu",
                       "--log-dir", str(tmp_path / "logs"),
                       "--run-dir", str(tmp_path / "runs")])
    out = capsys.readouterr().out
    assert "Starting Training..." in out and "Max accuracy:" in out
    assert len(result["accuracies"]) == 2
    assert np.isfinite(result["final_weights"].numpy()).all()


def test_engine_hands_the_attack_its_context():
    cfg = ExperimentConfig(dataset=C.SYNTH_MNIST_HARD, users_count=7,
                           synth_train=100, synth_test=20, batch_size=8)
    seen = []

    class Spy(DriftAttack):
        def craft(self, mal_grads, ctx=None):
            seen.append(ctx)
            return super().craft(mal_grads, ctx)

    exp = FederatedExperiment(cfg, Spy(1.5), device="cpu")
    w0 = exp.state.weights.clone()
    exp.run_round(0)
    exp.run_round(1)
    assert [c.round for c in seen] == [0, 1]
    assert torch.equal(seen[0].original_params, w0)
    assert seen[1].original_params is not w0
    lr = [c.learning_rate for c in seen]
    assert all(x.dtype == torch.float32 and x.ndim == 0 for x in lr)
    # The JAX round's f32 faded lr (a traced int32 round), bit for bit.
    for t in (0, 1, 3, 299, 12345):
        x = exp.attack_context(t).learning_rate
        want = np.asarray(jax.jit(
            lambda r: faded_learning_rate(0.1, 10000.0, r))(
                jnp.asarray(t, jnp.int32)))
        assert want.dtype == np.float32
        assert x.numpy().tobytes() == want.tobytes()
