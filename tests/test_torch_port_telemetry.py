"""The observatories, first half: telemetry and round stats of the port
against the JAX package.

Each defense's diagnostics (the ten, and the mask-aware five with
``mask`` and ``weights``) on the same numpy-seeded matrix as the JAX
function's, the aggregate bit-equal with the seam on and off; the
population stats, the groupwise envelope, the attacks' envelope stats;
the per-shard stacks of ``two_tier_aggregate``; the config refusals and
the CLI flags; and the flat and hierarchical event streams ('round',
'defense', 'attack', 'selection_hist', 'shard_selection', 'secagg')
against the JAX engine's (tests/_torch_port_observe.py: the pattern of
test_torch_port_round.py and its tolerances).  A run with the flags off
runs no observatory code and is byte-equal to the run with them on.

Tolerances on one matrix: selection masks, counts, kept and trim
fractions exact (NaN where the port's kernel reports no value, as the
JAX Pallas route does); scores, margins and distances within 2e-4 of
the largest |score| (the CPU's Gram against XLA's, d = 40 to 4,099);
norms, cosines and every other float within 2e-6 relative of the
field's scale (the CPU's f32 sums against XLA's).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from attacking_federate_learning_tpu.config import (
    ExperimentConfig as JConfig
)
from attacking_federate_learning_tpu.defenses import DEFENSES as JDEFENSES
from attacking_federate_learning_tpu.defenses.kernels import (
    TIER2_DEFENSES as JTIER2, population_telemetry as jax_population_telemetry
)
from attacking_federate_learning_tpu.ops.federated import (
    make_placement as jax_make_placement,
    two_tier_aggregate as jax_two_tier
)
from attacking_federate_learning_tpu.protocols.secagg import (
    group_envelope_stats as jax_group_envelope
)
from attacking_federate_learning_tpu.attacks.alie import (
    DriftAttack as JDrift
)
from attacking_federate_learning_tpu_torch import cli
from attacking_federate_learning_tpu_torch.attacks import DriftAttack
from attacking_federate_learning_tpu_torch.config import ExperimentConfig
from attacking_federate_learning_tpu_torch.core import engine as E
from attacking_federate_learning_tpu_torch.defenses import DEFENSES
from attacking_federate_learning_tpu_torch.defenses import kernels as K
from attacking_federate_learning_tpu_torch.defenses import median as MED
from attacking_federate_learning_tpu_torch.defenses.kernels import (
    TIER2_DEFENSES, population_telemetry
)
from attacking_federate_learning_tpu_torch.ops.federated import (
    make_placement, two_tier_aggregate
)
from attacking_federate_learning_tpu_torch.protocols.secagg import (
    group_envelope_stats
)

import _torch_port_observe as O

MASK_AWARE = ("NoDefense", "Krum", "TrimmedMean", "Median", "Bulyan")
BEYOND = ("DnC", "GeoMedian", "CenteredClip", "FLTrust", "NormBound")
EXACT = ("selection_mask", "kept_fraction", "trim_fraction",
         "num_tie_rows", "margin_kept_frac", "margin_trim_kept",
         "survivor_mask", "survivor_count", "clipped_count")
SCORE_LIKE = ("scores", "margin_selection", "margin_gap", "margin_slack")


def _matrix(n, d, seed, f=0):
    """A seeded (n, d) f32 cohort whose first f rows are one ALIE row."""
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(n, d)).astype(np.float32)
    if f:
        G[:f] = G[:f].mean(0) - 1.5 * G[:f].std(0)
    return G


def _dyadic(n, seed):
    return (2.0 ** -np.random.default_rng(seed).integers(0, 3, n)).astype(
        np.float32)


def _kwargs(name, G, seed):
    if name == "FLTrust":
        g0 = np.random.default_rng(seed + 1).normal(
            size=G.shape[1]).astype(np.float32)
        return {"server_grad": jnp.asarray(g0)}, {
            "server_grad": torch.from_numpy(g0)}
    if name == "DnC":
        return {"seed": 3, "round": 2}, {"seed": 3, "round": 2}
    return {}, {}


def assert_diag_close(jd, td, nan_in_port=()):
    """The port's diagnostics against JAX's on the same matrix."""
    assert set(jd) == set(td), sorted(set(jd) ^ set(td))
    jscores = np.asarray(jd.get("scores", np.zeros(1)), np.float64)
    scale = float(np.abs(jscores[np.isfinite(jscores)]).max(initial=1.0))
    for k in jd:
        x = np.asarray(jd[k], np.float64)
        y = td[k].detach().double().numpy()
        assert x.shape == y.shape, k
        if k in nan_in_port:
            assert np.isnan(y).all(), k
            continue
        if k in EXACT:
            np.testing.assert_array_equal(y, x, err_msg=k)
            continue
        fin = np.isfinite(x)
        np.testing.assert_array_equal(x[~fin], y[~fin], err_msg=k)
        if k in SCORE_LIKE or k == "dist_to_agg":
            tol = 2e-4 * scale
        else:
            tol = 2e-6 * float(np.abs(x[fin]).max(initial=0.0)) + 1e-7
        np.testing.assert_allclose(y[fin], x[fin], rtol=0, atol=tol,
                                   err_msg=k)


@pytest.mark.parametrize("name", MASK_AWARE + BEYOND)
def test_kernel_telemetry_bit_identical_and_fixed_shape(name):
    """The aggregate with telemetry is the aggregate without it, bit for
    bit, and the diagnostics are JAX's (fixed shapes, one dict)."""
    n, d, f = 19, 257, 4
    G = _matrix(n, d, 11, f)
    jkw, tkw = _kwargs(name, G, 11)
    tG = torch.from_numpy(G)
    off = DEFENSES[name](tG, n, f, **tkw)
    on, td = DEFENSES[name](tG, n, f, telemetry=True, **tkw)
    assert torch.equal(off.view(torch.int32), on.view(torch.int32))
    _, jd = JDEFENSES[name](jnp.asarray(G), n, f, telemetry=True, **jkw)
    nan = ("kept_fraction",) if name == "TrimmedMean" else ()
    assert_diag_close(jd, td, nan_in_port=nan)


@pytest.mark.parametrize("weighted", [False, True], ids=["mask", "weights"])
@pytest.mark.parametrize("name", MASK_AWARE)
def test_masked_weighted_telemetry_matches_jax(name, weighted):
    n, d, f = 15, 300, 2
    G = _matrix(n, d, 12, f)
    mask = np.array([True] * 11 + [False] * 4)
    w = _dyadic(n, 12) if weighted else None
    jkw = {"mask": jnp.asarray(mask)}
    tkw = {"mask": torch.from_numpy(mask)}
    if weighted:
        jkw["weights"], tkw["weights"] = jnp.asarray(w), torch.from_numpy(w)
    ja, jd = JDEFENSES[name](jnp.asarray(G), n, f, telemetry=True, **jkw)
    ta, td = DEFENSES[name](torch.from_numpy(G), n, f, telemetry=True,
                            **tkw)
    assert_diag_close(jd, td)
    off = DEFENSES[name](torch.from_numpy(G), n, f, **tkw)
    assert torch.equal(off.view(torch.int32), ta.view(torch.int32))


def test_krum_telemetry_mask_marks_aggregated_row():
    G = _matrix(12, 64, 13, 3)
    agg, diag = K.krum(torch.from_numpy(G), 12, 3, telemetry=True)
    assert float(diag["selection_mask"].sum()) == 1.0
    row = int(torch.argmax(diag["selection_mask"]))
    assert torch.equal(agg, torch.from_numpy(G)[row])


def test_bulyan_telemetry_mask_is_selection_set():
    G = _matrix(15, 64, 14)
    sel = K.bulyan_select(K.distances_for(torch.from_numpy(G)), 15, 2)
    _, diag = K.bulyan(torch.from_numpy(G), 15, 2, telemetry=True)
    want = np.zeros(15, np.float32)
    want[sel.numpy()] = 1.0
    np.testing.assert_array_equal(diag["selection_mask"].numpy(), want)


def test_population_and_group_envelope_match_jax():
    """Per-client norms and cosines (relative 2e-6), and under groupwise
    secagg the group envelope, whose sum norms are the engine's 'secagg'
    ``group_sum_norms`` spelling bit for bit."""
    G = _matrix(19, 4099, 15, 4)
    jp = jax_population_telemetry(jnp.asarray(G))
    tp = population_telemetry(torch.from_numpy(G))
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=2e-6, atol=1e-7)
    E_ = _matrix(10, 4099, 16)
    je = jax_group_envelope(jnp.asarray(E_), 100)
    te = group_envelope_stats(torch.from_numpy(E_), 100)
    for k in je:
        np.testing.assert_allclose(te[k].numpy(), np.asarray(je[k]),
                                   rtol=2e-6, atol=1e-7)
    est = torch.from_numpy(E_)
    assert torch.equal(te["group_sum_norms"],
                       est.square().sum(1).sqrt() * 100)


def test_attack_envelope_stats_match_jax():
    """ALIE's envelope and utilization stats (relative 2e-6); the base
    attack reports none."""
    n, f = 19, 4
    G = _matrix(n, 4099, 17)
    crafted = G.copy()
    crafted[:f] = G[:f].mean(0) - 1.5 * G[:f].std(0)
    ja, ta = JDrift(1.5), DriftAttack(1.5)
    for jfn, tfn, extra in (
            (ja.envelope_stats, ta.envelope_stats, {}),
            (ja.margin_stats, ta.margin_stats, {"crafted": True})):
        jkw = {"crafted": jnp.asarray(crafted)} if extra else {}
        tkw = {"crafted": torch.from_numpy(crafted)} if extra else {}
        js = jfn(jnp.asarray(G), f, None, **jkw)
        ts = tfn(torch.from_numpy(G), f, None, **tkw)
        assert set(js) == set(ts)
        for k in js:
            np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                       rtol=2e-6)
    assert DriftAttack(0.0).envelope_stats(torch.from_numpy(G), f) == {}
    assert DriftAttack(1.5).margin_stats(torch.from_numpy(G), 0) == {}


@pytest.mark.parametrize("masked", [False, True], ids=["clear", "mask"])
@pytest.mark.parametrize("tiers", [("Krum", "Median"),
                                   ("TrimmedMean", "Krum")])
def test_two_tier_telemetry_stacks_match_jax(tiers, masked):
    """``two_tier_aggregate(telemetry=True)``: each shard's row of the
    stacked tier-1 diagnostics is the flat defense's on its rows, and the
    tier-2 record is over the shard axis, as the JAX function's."""
    n, m, f = 40, 8, 4
    G = _matrix(n, 257, 18, f)
    t1, t2 = tiers
    place, jplace = make_placement(n, f, m), jax_make_placement(n, f, m)
    mask = np.ones(n, bool)
    if masked:
        mask[np.random.default_rng(18).permutation(n)[:6]] = False
    jkw = {"mask": jnp.asarray(mask)} if masked else {}
    tkw = {"mask": torch.from_numpy(mask)} if masked else {}
    ja, jd1, jd2 = jax_two_tier(jnp.asarray(G), jplace, JDEFENSES[t1],
                                JTIER2[t2], 1, 1, telemetry=True, **jkw)
    ta, td1, td2 = two_tier_aggregate(torch.from_numpy(G), place,
                                      DEFENSES[t1], TIER2_DEFENSES[t2], 1,
                                      1, telemetry=True, **tkw)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0,
                               atol=1e-5)
    nan = ("kept_fraction",) if t1 == "TrimmedMean" and not masked else ()
    assert_diag_close(jd1, td1, nan_in_port=nan)
    assert_diag_close(jd2, td2)
    assert all(v.shape[0] == place.num_shards for v in td1.values())


def test_config_refuses_telemetry_and_round_stats_under_vanilla_secagg():
    """JAX's messages word for word."""
    base = dict(defense="NoDefense", secagg="vanilla", users_count=12)
    for flag in ("telemetry", "log_round_stats"):
        with pytest.raises(ValueError) as want:
            JConfig(**base, **{flag: True})
        with pytest.raises(ValueError) as got:
            ExperimentConfig(**base, **{flag: True})
        assert str(got.value) == str(want.value)
    # Groupwise admits both.
    ExperimentConfig(defense="NoDefense", secagg="groupwise",
                     aggregation="hierarchical", megabatch=4,
                     users_count=12, telemetry=True, log_round_stats=True)


def test_cli_flags_set_the_four_fields():
    args = cli.build_parser().parse_args(
        ["-s", "SYNTH_MNIST", "-d", "Krum", "--telemetry", "--margins",
         "--numerics", "--round-stats"])
    cfg = cli.config_from_args(args)
    assert (cfg.telemetry, cfg.margins, cfg.numerics,
            cfg.log_round_stats) == (True, True, True, True)
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        ["-s", "SYNTH_MNIST"]))
    assert not (cfg.telemetry or cfg.margins or cfg.numerics
                or cfg.log_round_stats)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """The port on two intra-op threads, for speed: beside the other test
    workers, a machine's every core per worker spins more than it
    computes.  Each engine pair here runs at the same setting, and the
    diagnostics are held to JAX's within bands."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ds():
    return O.datasets()


@pytest.mark.parametrize("defense", ["Krum", "TrimmedMean", "Bulyan"])
def test_flat_telemetry_events_match_the_jax_engine(defense, ds, tmp_path):
    """Two flat rounds with the four flags: 'round', 'defense', 'attack',
    'margin', 'numerics' and (Krum) 'selection_hist' events equal to the
    JAX engine's within the module's tolerances; the kept fraction NaN
    where the port's trimmed-mean kernel reports none, its
    ``margin_kept_frac`` within the tolerance of JAX's real one."""
    jexp, texp = O.pair(ds, defense=defense, **O.FLAGS)
    jev, tev = O.run_events(jexp, texp, tmp_path)
    kinds = ["round", "defense", "attack", "margin", "numerics"]
    if defense == "Krum":
        kinds.append("selection_hist")
    nan = ("kept_fraction",) if defense == "TrimmedMean" else ()
    O.compare_events(jev, tev, kinds, nan_in_port=nan,
                     skip=("cancel_bits",) if defense == "Bulyan" else ())
    if defense == "TrimmedMean":
        J, T = O.by_kind(jev), O.by_kind(tev)
        for je, te in zip(J["margin"], T["margin"]):
            de = [e for e in J["defense"] if e["round"] == je["round"]][0]
            np.testing.assert_allclose(te["margin_kept_frac"],
                                       de["kept_fraction"], atol=2e-5)
    np.testing.assert_allclose(texp.state.weights.numpy(),
                               np.asarray(jexp.state.weights), atol=1e-5)


def test_hier_shard_selection_events_match_the_jax_engine(ds, tmp_path):
    """Hierarchical Krum/Median at n = 20 in 4 megabatches: one
    'shard_selection' event a round with the placement's static fields
    and the (S, m) stacks, 'round' with the per-client norm stats."""
    kw = dict(users_count=20, mal_prop=0.2, aggregation="hierarchical",
              megabatch=5, tier2_defense="Median", defense="Krum",
              **O.FLAGS)
    jexp, texp = O.pair(ds, **kw)
    jev, tev = O.run_events(jexp, texp, tmp_path)
    O.compare_events(jev, tev, ["round", "shard_selection", "margin",
                                "numerics"])
    sel = O.by_kind(tev)["shard_selection"][0]
    assert np.shape(sel["shard_selection_mask"]) == (4, 5)
    assert sel["mal_counts"] == [int(c) for c in
                                 texp._placement.mal_counts]


def test_groupwise_secagg_telemetry_matches_the_jax_engine(ds, tmp_path):
    """Groupwise secagg with --telemetry and --round-stats: the 'secagg'
    events carry ``group_cos_to_mean`` and their ``group_sum_norms`` are
    the same bits as the run's without telemetry; 'round' reports the
    group sums' norm stats; the tier-2 'shard_selection' record."""
    kw = dict(users_count=20, mal_prop=0.2, aggregation="hierarchical",
              megabatch=5, tier2_defense="Krum", defense="NoDefense",
              secagg="groupwise", telemetry=True, log_round_stats=True)
    jexp, texp = O.pair(ds, **kw)
    jev, tev = O.run_events(jexp, texp, tmp_path)
    O.compare_events(jev, tev, ["round", "secagg", "shard_selection"])
    _, twin = O.pair(ds, **{**kw, "telemetry": False,
                            "log_round_stats": False})
    rows = twin.run(log=lambda s: None)["secagg"]
    got = [e for e in tev if e["kind"] == "secagg"]
    assert [r["group_sum_norms"] for r in rows] == [
        e["group_sum_norms"] for e in got]
    assert all(len(e["group_cos_to_mean"]) == 4 for e in got)
    assert torch.equal(twin.state.weights.view(torch.int32),
                       texp.state.weights.view(torch.int32))


def test_flags_off_runs_no_observatory_code(ds, monkeypatch):
    """With the four flags off a round calls no observatory function (so
    it runs what it ran before them: no extra launch, no extra read), and
    its final state is byte-equal to the same run with all four on."""
    def boom(*a, **k):
        raise AssertionError("observatory code ran with the flags off")

    cases = [dict(defense="Krum"), dict(defense="TrimmedMean"),
             dict(defense="Bulyan", mal_prop=0.06,
                  faults=dict(dropout=0.15, corrupt=0.1)),
             dict(defense="Median", aggregation="async", async_buffer=9,
                  staleness_weight="poly"),
             dict(defense="Krum", users_count=20, mal_prop=0.2,
                  aggregation="hierarchical", megabatch=5)]
    states = []
    for flags in ({}, O.FLAGS):
        with monkeypatch.context() as mp:
            if not flags:
                for mod, names in (
                        (E, ("population_telemetry", "nonfinite_count",
                             "norm_dynamic_range", "mean_as_xla",
                             "row_norms")),
                        (K, ("krum_margins", "rank_keep_margins",
                             "tie_proximity", "cancellation_bits",
                             "gram_cancellation_bits", "trim_margins",
                             "scatter_rows", "row_norms",
                             "max_finite_abs")),
                        (MED, ("median_pick_margins", "row_norms",
                               "tie_proximity", "max_finite_abs"))):
                    for name in names:
                        mp.setattr(mod, name, boom)
            for case in cases:
                case = dict(case)
                faults = case.pop("faults", None)
                _, texp = O.pair(ds, faults=faults, **case, **flags)
                texp.run(log=lambda s: None)
                states.append(texp.state)
    off, on = states[:len(cases)], states[len(cases):]
    for a, b in zip(off, on):
        assert torch.equal(a.weights.view(torch.int32),
                           b.weights.view(torch.int32))
        assert torch.equal(a.velocity.view(torch.int32),
                           b.velocity.view(torch.int32))
