"""The port's hierarchical (two-tier) round vs the JAX package's.

``ops/federated.py``, the tier-2 entries of ``defenses/kernels.py`` and
the engine's hierarchical round, on the CPU (the kernels' plain
versions):

- ``make_placement`` in both placements over a grid of (n, f, m): grid,
  malicious counts and scan groups equal to JAX's; ``tier1_assumed``,
  ``tier2_assumed`` and ``auto_megabatch`` equal to JAX's;
- ``two_tier_aggregate`` against JAX's (XLA defenses) on one seeded
  materialized matrix under each of the five tier-2 names, without and
  with a quarantine mask, and with staleness weights: within 2 n eps of
  the largest |g| (selections and medians exact); each tier-1 estimate
  is bit for bit the port's flat defense on its megabatch's rows, in the
  helper and in the engine's estimate buffer;
- three hierarchical rounds of the port's engine against the JAX
  engine's sequential hierarchical rounds (mnist_mlp, n = 56, m = 8, S =
  7, f = 8, ALIE), for five tier-1/tier-2 pairs that give every defense
  a turn at each tier, in both placements ('concentrated' puts all m
  rows of one megabatch in the colluders' hands), and with the backdoor:
  the weights within a relative L2 error of 1e-6 (measured below 1e-7);
- the config's, the engine's and the CLI's messages and help texts equal
  to JAX's; the refusals of what the port has not ported (the device
  mesh, secure aggregation); a CLI run.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attacking_federate_learning_tpu import cli as jax_cli
from attacking_federate_learning_tpu import config as JC
from attacking_federate_learning_tpu.attacks import DriftAttack as JDrift
from attacking_federate_learning_tpu.attacks.backdoor import (
    BackdoorAttack as JBackdoor
)
from attacking_federate_learning_tpu.config import (
    ExperimentConfig as JConfig
)
from attacking_federate_learning_tpu.core.engine import (
    FederatedExperiment as JExperiment
)
from attacking_federate_learning_tpu.data.datasets import (
    load_dataset as jax_load_dataset
)
from attacking_federate_learning_tpu.defenses import DEFENSES as JDEFENSES
from attacking_federate_learning_tpu.defenses.kernels import (
    TIER2_DEFENSES as JTIER2
)
from attacking_federate_learning_tpu.ops import federated as JFD
from attacking_federate_learning_tpu_torch import cli
from attacking_federate_learning_tpu_torch import config as C
from attacking_federate_learning_tpu_torch.attacks import (
    DriftAttack, make_attacker
)
from attacking_federate_learning_tpu_torch.config import ExperimentConfig
from attacking_federate_learning_tpu_torch.core.engine import (
    FederatedExperiment
)
from attacking_federate_learning_tpu_torch.core.server import (
    init_server_state
)
from attacking_federate_learning_tpu_torch.data.datasets import load_dataset
from attacking_federate_learning_tpu_torch.defenses import DEFENSES
from attacking_federate_learning_tpu_torch.defenses.kernels import (
    TIER2_DEFENSES, check_tier2_args
)
from attacking_federate_learning_tpu_torch.ops import federated as FD
from attacking_federate_learning_tpu_torch.utils.weights import (
    from_jax_params
)

N, M, MAL_PROP, B, ROUNDS = 56, 8, 0.15, 16, 3
SIZES = dict(synth_train=1000, synth_test=100)
NAMES = ("NoDefense", "Krum", "TrimmedMean", "Bulyan", "Median")
# (tier 1, tier 2): every defense at each tier once.  At m = 8 Bulyan's
# tier-1 bound 4 f1 + 3 <= m needs f1 = 1 (the default is ceil(8/7) = 2);
# at S = 7 the tier-2 default f2 = ceil(8/8) = 1 meets it.
PAIRS = [("Krum", "Bulyan"), ("Bulyan", "TrimmedMean"),
         ("TrimmedMean", "Median"), ("Median", "NoDefense"),
         ("NoDefense", "Krum")]
# The engines' band: relative L2 error of the weights after three rounds.
REL_L2 = 1e-6


def _jax_arr(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# placement and the assumed bounds

_GRID = [(n, f, m) for n, m in ((12, 3), (12, 4), (20, 5), (56, 8),
                                (100, 10), (1000, 100))
         for f in sorted({0, 1, m - 1, m, m + 1, n // 4, n // 2})
         if f <= n]


@pytest.mark.parametrize("placement", ["spread", "concentrated"])
def test_make_placement_is_jax_s(placement):
    for n, f, m in _GRID:
        got = FD.make_placement(n, f, m, placement)
        want = JFD.make_placement(n, f, m, placement)
        np.testing.assert_array_equal(got.grid, want.grid)
        assert got.grid.dtype == want.grid.dtype
        assert got.mal_counts == want.mal_counts
        assert got.groups == want.groups
        assert (got.megabatch, got.num_shards) == (want.megabatch,
                                                   want.num_shards)
        # Malicious ids first in each megabatch, every client once.
        for s, c in enumerate(got.mal_counts):
            assert (got.grid[s, :c] < f).all() and (got.grid[s, c:] >= f).all()
        assert sorted(got.grid.ravel().tolist()) == list(range(n))


@pytest.mark.parametrize("n,m,placement", [(12, 5, "spread"),
                                           (12, 0, "spread"),
                                           (12, 4, "diagonal")])
def test_make_placement_messages_are_jax_s(n, m, placement):
    with pytest.raises(ValueError) as je:
        JFD.make_placement(n, 2, m, placement)
    with pytest.raises(ValueError) as te:
        FD.make_placement(n, 2, m, placement)
    assert str(te.value) == str(je.value)


def test_assumed_bounds_and_auto_megabatch_are_jax_s():
    for f in range(0, 60):
        for k in range(1, 40):
            assert FD.tier1_assumed(f, k) == JFD.tier1_assumed(f, k)
            assert FD.tier2_assumed(f, k) == JFD.tier2_assumed(f, k)
    for n in list(range(1, 300)) + [1000, 4096, 10_000, 1 << 20]:
        for cap in (1, 8, 100, 512):
            assert FD.auto_megabatch(n, cap) == JFD.auto_megabatch(n, cap)


# ---------------------------------------------------------------------------
# the two tiers over a materialized matrix

def _matrix(seed=0, n=N, d=257):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, d)).astype(np.float32)
    G[:8] += 3.0                          # a colluding offset, rows [0, f)
    mask = rng.random(n) > 0.2
    w = rng.uniform(0.25, 1.0, n).astype(np.float32)
    return G, mask, w


def _tier1_for(tier2):
    return dict((b, a) for a, b in PAIRS)[tier2]


@pytest.mark.parametrize("mode", ["plain", "mask", "weights"])
@pytest.mark.parametrize("tier2", NAMES)
def test_two_tier_aggregate_is_jax_s(tier2, mode):
    tier1 = _tier1_for(tier2)
    if mode == "weights" and tier1 == "Bulyan":
        tier1 = "TrimmedMean"
    G, mask, w = _matrix()
    place = FD.make_placement(N, 8, M, "spread")
    jplace = JFD.make_placement(N, 8, M, "spread")
    kw_t, kw_j = {}, {}
    if mode != "plain":
        kw_t["mask"] = torch.from_numpy(mask)
        kw_j["mask"] = jnp.asarray(mask)
    if mode == "weights":
        kw_t["weights"] = torch.from_numpy(w)
        kw_j["weights"] = jnp.asarray(w)
    got = FD.two_tier_aggregate(torch.from_numpy(G), place, DEFENSES[tier1],
                                TIER2_DEFENSES[tier2], 1, 1, **kw_t)
    want = JFD.two_tier_aggregate(jnp.asarray(G), jplace, JDEFENSES[tier1],
                                  JTIER2[tier2], 1, 1, **kw_j)
    exact = {tier1, tier2} <= {"Krum", "Median"}
    atol = 0.0 if exact else 2 * N * np.finfo(np.float32).eps * np.abs(
        G).max() * (4.0 if mode == "weights" else 1.0)
    np.testing.assert_allclose(got.numpy(), _jax_arr(want), rtol=0,
                               atol=atol)


def test_weights_without_mask_message_is_jax_s():
    G, _, w = _matrix()
    with pytest.raises(ValueError) as je:
        JFD.two_tier_aggregate(jnp.asarray(G), JFD.make_placement(N, 8, M),
                               JDEFENSES["TrimmedMean"],
                               JTIER2["TrimmedMean"], 1, 1,
                               weights=jnp.asarray(w))
    with pytest.raises(ValueError) as te:
        FD.two_tier_aggregate(torch.from_numpy(G), FD.make_placement(N, 8, M),
                              DEFENSES["TrimmedMean"],
                              TIER2_DEFENSES["TrimmedMean"], 1, 1,
                              weights=torch.from_numpy(w))
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("tier1", NAMES)
def test_each_tier1_estimate_is_the_flat_defense_on_its_rows(tier1, masked):
    G, mask, _ = _matrix(seed=3)
    Gt, mt = torch.from_numpy(G), torch.from_numpy(mask)
    place = FD.make_placement(N, 8, M, "concentrated")
    seen = {}

    def tier2(est, S, f2, alive_counts=None):
        seen["est"], seen["alive"] = est.clone(), alive_counts
        return est.mean(0)

    FD.two_tier_aggregate(Gt, place, DEFENSES[tier1], tier2, 1, 1,
                          mask=mt if masked else None)
    assert seen["est"].shape == (place.num_shards, G.shape[1])
    for s in range(place.num_shards):
        rows = Gt[torch.from_numpy(place.grid[s].astype(np.int64))]
        kw = {}
        if masked:
            kw["mask"] = mt[torch.from_numpy(place.grid[s].astype(np.int64))]
        want = DEFENSES[tier1](rows, M, 1, **kw).float()
        assert torch.equal(seen["est"][s], want), s
        if masked:
            assert int(seen["alive"][s]) == int(kw["mask"].sum())


def test_tier2_nodefense_is_the_alive_weighted_mean():
    """Without faults the flat mean of equal megabatches up to the order
    of summation; with alive counts the per-client weighting of the
    flat masked mean."""
    G, mask, _ = _matrix(seed=5)
    place = FD.make_placement(N, 8, M)
    Gt, mt = torch.from_numpy(G), torch.from_numpy(mask)
    got = FD.two_tier_aggregate(Gt, place, DEFENSES["NoDefense"],
                                TIER2_DEFENSES["NoDefense"], 0, 0)
    eps = np.finfo(np.float32).eps
    np.testing.assert_allclose(got.numpy(), G.mean(0), rtol=0,
                               atol=4 * N * eps * np.abs(G).max())
    got = FD.two_tier_aggregate(Gt, place, DEFENSES["NoDefense"],
                                TIER2_DEFENSES["NoDefense"], 0, 0, mask=mt)
    np.testing.assert_allclose(got.numpy(), G[mask].mean(0), rtol=0,
                               atol=4 * N * eps * np.abs(G).max())


def test_shard_entries_exclude_dead_shards():
    """A shard at alive count 0 never reaches a tier-2 estimate: each
    entry equals the flat defense over the surviving shards alone."""
    rng = np.random.default_rng(9)
    E = torch.from_numpy(rng.standard_normal((9, 33)).astype(np.float32))
    alive = torch.tensor([8, 0, 7, 8, 0, 6, 8, 8, 5])
    E[1] = 1e6
    E[4] = -1e6
    keep = alive > 0
    for name in NAMES:
        got = TIER2_DEFENSES[name](E, 9, 1, alive_counts=alive)
        if name == "NoDefense":
            w = alive[keep].float()
            want = (w @ E[keep]) / w.sum()
        else:
            want = DEFENSES[name](E[keep].contiguous(), int(keep.sum()), 1)
        assert torch.allclose(got, want, rtol=0, atol=1e-5), name


@pytest.mark.parametrize("name,S,f2", [("Krum", 4, 2), ("Bulyan", 6, 1),
                                       ("TrimmedMean", 3, 2),
                                       ("TrimmedMean", 4, 2),
                                       ("Median", 2, 5)])
def test_check_tier2_args_is_jax_s(name, S, f2):
    from attacking_federate_learning_tpu.defenses.kernels import (
        check_tier2_args as jax_check
    )
    try:
        jax_check(name, S, f2)
    except ValueError as e:
        with pytest.raises(ValueError) as te:
            check_tier2_args(name, S, f2)
        assert str(te.value) == str(e)
    else:
        check_tier2_args(name, S, f2)


# ---------------------------------------------------------------------------
# rounds through the engines

@pytest.fixture(scope="module")
def datasets():
    return (jax_load_dataset(JC.SYNTH_MNIST, seed=0, **SIZES),
            load_dataset(C.SYNTH_MNIST, seed=0, **SIZES))


def _base(**kw):
    base = dict(dataset=C.SYNTH_MNIST, users_count=N, mal_prop=MAL_PROP,
                batch_size=B, epochs=ROUNDS, test_step=ROUNDS,
                aggregation="hierarchical", megabatch=M, **SIZES)
    base.update(kw)
    return base


def _pair(datasets, attack="alie", **kw):
    """A JAX engine (XLA defenses, sequential scan) and a port engine on
    the CPU of one hierarchical config, the port started from the JAX
    engine's initial weights."""
    base = _base(**kw)
    jcfg, tcfg = JConfig(**base, aggregation_impl="xla"), ExperimentConfig(
        **base)
    if attack == "backdoor":
        jatt = JBackdoor(jcfg, datasets[0])
        tatt = make_attacker(tcfg, datasets[1], device="cpu")
    else:
        jatt, tatt = JDrift(1.0), DriftAttack(1.0)
    jexp = JExperiment(jcfg, attacker=jatt, dataset=datasets[0])
    texp = FederatedExperiment(tcfg, tatt, datasets[1], device="cpu")
    params = jax.tree.map(np.asarray, jexp.flat.unravel(jexp.state.weights))
    texp.state = init_server_state(from_jax_params(params))
    return jexp, texp


def rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _check_rounds(jexp, texp, rounds=ROUNDS):
    for t in range(rounds):
        jexp.run_round(t)
        texp.run_round(t)
        assert texp.state.round == t + 1
    w = np.asarray(jexp.state.weights)
    assert rel_l2(texp.state.weights.numpy(), w) <= REL_L2
    assert rel_l2(texp.state.velocity.numpy(),
                  np.asarray(jexp.state.velocity)) <= REL_L2


@pytest.mark.parametrize("placement", ["spread", "concentrated"])
@pytest.mark.parametrize("tier1,tier2", PAIRS,
                         ids=[f"{a}-{b}" for a, b in PAIRS])
def test_three_hierarchical_rounds_match_the_jax_engine(tier1, tier2,
                                                        placement, datasets):
    kw = dict(defense=tier1, tier2_defense=tier2, mal_placement=placement)
    if tier1 == "Bulyan":
        kw["tier1_corrupted"] = 1
    jexp, texp = _pair(datasets, **kw)
    assert texp._placement.mal_counts == jexp._placement.mal_counts
    assert (texp._tier1_f, texp._tier2_f, texp._tier2_name) == (
        jexp._tier1_f, jexp._tier2_f, jexp._tier2_name)
    if placement == "concentrated":
        assert texp._placement.mal_counts[0] == M     # an all-colluder shard
    # Each tier-1 estimate in the engine's buffer is the flat defense on
    # that megabatch's delivered, crafted rows.
    seen = []
    inner = texp.defense_fn

    def spy(grads, n, f, **kw):
        out = inner(grads, n, f, **kw)
        seen.append((grads.clone(), n, f, out.clone()))
        return out

    texp.defense_fn = spy
    _check_rounds(jexp, texp)
    S = texp._placement.num_shards
    assert len(seen) == ROUNDS * S
    for s, (grads, n, f, out) in enumerate(seen[-S:]):
        assert (n, f) == (M, texp._tier1_f)
        assert torch.equal(texp._estimates[s], inner(grads, n, f).float())
        assert torch.equal(texp._estimates[s], out.float())


def test_three_backdoor_rounds_match_the_jax_engine(datasets):
    """The backdoor crafts once per megabatch from that megabatch's
    malicious rows; 'concentrated' puts them all in megabatch 0."""
    jexp, texp = _pair(datasets, attack="backdoor", backdoor="pattern",
                       mal_batch_size=64, defense="TrimmedMean",
                       tier2_defense="Median", mal_placement="concentrated")
    assert texp._check_attack_nan and jexp._check_attack_nan
    crafts = []
    inner = texp.attacker.craft

    def spy(mal, ctx):
        crafts.append((mal.shape[0], ctx.check_finite))
        return inner(mal, ctx)

    texp.attacker.craft = spy
    _check_rounds(jexp, texp)
    assert crafts == [(M, False)] * ROUNDS


def test_the_nan_guard_raises_once_a_round_and_keeps_the_state(datasets):
    _, texp = _pair(datasets, attack="backdoor", backdoor="pattern",
                    mal_batch_size=64, defense="Median",
                    tier2_defense="Median")
    texp.attacker.craft = lambda mal, ctx: torch.full(mal.shape[1:],
                                                      math.nan)
    w0 = texp.state.weights.clone()
    with pytest.raises(FloatingPointError,
                       match="Got nan in backdoor shadow training"):
        texp.run_round(0)
    assert torch.equal(texp.state.weights, w0) and texp.state.round == 0


def test_the_round_never_builds_the_client_matrix(datasets):
    """Every matrix a round hands its defenses is one megabatch's."""
    _, texp = _pair(datasets, defense="Median", tier2_defense="Krum")
    shapes = []
    inner = texp.compute_grads

    def spy(t, part=None):
        out = inner(t, part)
        shapes.append(tuple(out.shape))
        return out

    texp.compute_grads = spy
    texp.run_round(0)
    d = texp.flat.dim
    assert shapes == [(M, d)] * (N // M)
    assert tuple(texp._estimates.shape) == (N // M, d)


def test_run_evaluates_and_is_finite(datasets):
    cfg = ExperimentConfig(**_base(defense="Krum", tier2_defense="Median",
                                   epochs=4, test_step=2))
    exp = FederatedExperiment(cfg, DriftAttack(1.0), datasets[1],
                              device="cpu")
    lines = []
    out = exp.run(log=lines.append)
    assert out["epochs"] == [0, 2, 3]
    assert all(math.isfinite(a) for a in out["accuracies"])
    assert bool(torch.isfinite(out["final_weights"]).all())
    assert "traffic" not in out and "faults" not in out
    assert sum("Test set:" in line for line in lines) == 3


# ---------------------------------------------------------------------------
# messages, flags and the CLI

_CONFIG_ERRORS = [
    dict(aggregation="hierarchical"),
    dict(aggregation="hierarchical", megabatch=7),
    dict(aggregation="hierarchical", users_count=100, megabatch=100),
    dict(mal_placement="diagonal"),
    dict(megabatch=-1),
    dict(tier2_defense="DnC"),
    dict(tier1_corrupted=-1),
    dict(tier2_corrupted=-2),
]


@pytest.mark.parametrize("kw", _CONFIG_ERRORS,
                         ids=["no-megabatch", "not-dividing", "one-shard",
                              "placement", "negative-megabatch", "tier2",
                              "tier1-f", "tier2-f"])
def test_config_messages_are_jax_s(kw):
    with pytest.raises(ValueError) as je:
        JConfig(**kw)
    with pytest.raises(ValueError) as te:
        ExperimentConfig(**kw)
    assert str(te.value) == str(je.value)


def test_config_defaults_are_jax_s():
    j, t = JConfig(), ExperimentConfig()
    for name in ("megabatch", "tier2_defense", "mal_placement",
                 "tier1_corrupted", "tier2_corrupted"):
        assert getattr(t, name) == getattr(j, name), name
    ExperimentConfig(aggregation="hierarchical", users_count=100,
                     megabatch=50)
    # Inert outside hierarchical rounds, as in the JAX package.
    ExperimentConfig(megabatch=7, mal_placement="concentrated")


_ENGINE_ERRORS = [
    dict(participation=0.5, defense="Krum"),
    dict(defense="DnC"),
    dict(defense="GeoMedian"),
    dict(defense="Bulyan"),
    dict(defense="Krum", tier2_defense="Bulyan", tier2_corrupted=2),
    dict(defense="Median", tier2_defense="TrimmedMean", tier2_corrupted=6),
    dict(defense="Krum", megabatch=4, tier1_corrupted=2),
]


@pytest.mark.parametrize("kw", _ENGINE_ERRORS,
                         ids=["participation", "dnc", "geomed",
                              "bulyan-tier1", "bulyan-tier2",
                              "trimmed-tier2", "krum-tier1"])
def test_engine_messages_are_jax_s(kw, datasets):
    base = _base(**kw)
    with pytest.raises(ValueError) as je:
        JExperiment(JConfig(**base), attacker=JDrift(1.0),
                    dataset=datasets[0])
    with pytest.raises(ValueError) as te:
        FederatedExperiment(ExperimentConfig(**base), DriftAttack(1.0),
                            datasets[1], device="cpu")
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("knob,value,word", [
    ("mesh_shape", (2, 1), "multi-GPU slice"),
    ("secagg", "groupwise", "secure aggregation")])
def test_what_is_not_ported_is_refused(knob, value, word, datasets):
    cfg = ExperimentConfig(**_base(defense="Krum"))
    setattr(cfg, knob, value)
    with pytest.raises(ValueError, match=word):
        FederatedExperiment(cfg, DriftAttack(1.0), datasets[1], device="cpu")


_FLAGS = ("aggregation", "megabatch", "tier2_defense", "mal_placement",
          "tier1_corrupted", "tier2_corrupted", "fault_shard_dropout",
          "fault_shard_dropout_dwell")


def _actions(parser, keep):
    return {a.dest: (a.option_strings, a.default, a.choices, a.help,
                     a.type, a.metavar)
            for a in parser._actions if a.dest in keep}


def test_cli_flags_have_jax_s_names_defaults_and_help():
    got = _actions(cli.build_parser(), _FLAGS)
    want = _actions(jax_cli.build_parser(), _FLAGS)
    assert sorted(got) == sorted(_FLAGS)
    assert got == want


@pytest.mark.parametrize("argv", [
    [],
    ["--aggregation", "hierarchical", "-n", "40", "--megabatch", "8"],
    ["--aggregation", "hierarchical", "-n", "40", "--megabatch", "10",
     "--tier2-defense", "Median", "--mal-placement", "concentrated",
     "--tier1-corrupted", "1", "--tier2-corrupted", "0"]])
def test_cli_builds_jax_s_config(argv):
    got = cli.config_from_args(cli.build_parser().parse_args(argv))
    want = jax_cli.config_from_args(jax_cli.build_parser().parse_args(argv))
    for name in ("aggregation", "users_count", "megabatch", "tier2_defense",
                 "mal_placement", "tier1_corrupted", "tier2_corrupted"):
        assert getattr(got, name) == getattr(want, name), name


def test_cli_runs_a_hierarchical_round(tmp_path, capsys):
    out = cli.main(["-s", C.SYNTH_MNIST, "-d", "Krum", "-n", "20", "-m",
                    "0.2", "-e", "2", "-c", "16", "--aggregation",
                    "hierarchical", "--megabatch", "5", "--tier2-defense",
                    "Median", "--synth-train", "400", "--synth-test", "100",
                    "--test-step", "1", "--log-dir", str(tmp_path / "logs"),
                    "--run-dir", str(tmp_path / "runs"), "--device", "cpu"])
    text = capsys.readouterr().out
    assert out["epochs"] == [0, 1]
    assert text.count("Test set:") == 2
    assert all(math.isfinite(a) for a in out["accuracies"])


def test_config_round_trips_through_asdict():
    cfg = ExperimentConfig(aggregation="hierarchical", users_count=100,
                           megabatch=25,
                           tier2_defense="Krum", mal_placement="concentrated",
                           tier1_corrupted=1, tier2_corrupted=1)
    again = ExperimentConfig(**dataclasses.asdict(cfg))
    assert again == cfg
