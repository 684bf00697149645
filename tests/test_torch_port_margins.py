"""The margin observatory (utils/margins.py) of the port against the JAX
package.

Exactness identities on seeded matrices: a row is Krum/Bulyan-selected
iff its margin > 0, the winner's margin is the gap, and identical crafted
rows tie-lock at exactly 0.0 (the fused score route and the masked sort
route alike); ``margin_kept_frac`` bit-equal to the kept fraction of the
JAX package's XLA route; the median's picks reconstruct the aggregate;
the device reductions equal JAX's on the same inputs (ranks and kept
fractions exactly, ties included; distances and boundary distances
within 2e-6 relative of their scale, the CPU's f32 sums against XLA's);
the host rollups, series and drift equal JAX's functions on the same
fields; the seam guards and config refusals word for word; the
faulted, traffic (with the round's ``f_eff``) and async 'margin' event
streams against the JAX engine's (tests/_torch_port_observe.py's
tolerances); and the science gate's two 30-round Bulyan cells
(tools/science_gate.py: ``bulyan_margin_collapse``,
``bulyan_margin_rescue``) with their discriminators inside
BEHAVIOR_BASELINE.json's bands.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from attacking_federate_learning_tpu.config import (
    ExperimentConfig as JConfig
)
from attacking_federate_learning_tpu.defenses import DEFENSES as JDEFENSES
from attacking_federate_learning_tpu.defenses.kernels import (
    check_margin_seam as jax_check_margin_seam
)
from attacking_federate_learning_tpu.utils import margins as JM
from attacking_federate_learning_tpu_torch import config as C
from attacking_federate_learning_tpu_torch.attacks import DriftAttack
from attacking_federate_learning_tpu_torch.config import ExperimentConfig
from attacking_federate_learning_tpu_torch.core.engine import (
    FederatedExperiment
)
from attacking_federate_learning_tpu_torch.data.datasets import load_dataset
from attacking_federate_learning_tpu_torch.defenses import DEFENSES
from attacking_federate_learning_tpu_torch.defenses import kernels as K
from attacking_federate_learning_tpu_torch.utils import margins as M
from attacking_federate_learning_tpu_torch.utils.metrics import RunLogger

import _torch_port_observe as O

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _grads(n=12, d=40, seed=0, f=0):
    G = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    if f:
        G[:f] = G[:f].mean(0) - 0.1 * G[:f].std(0)
    return G


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_krum_margin_identity():
    """Selected iff margin > 0, and the winner's margin is the gap."""
    agg, diag = K.krum(_t(_grads(11, 30)), 11, 2, telemetry=True,
                       margins=True)
    sel = diag["selection_mask"].numpy()
    m = diag["margin_selection"].numpy()
    scores = np.sort(diag["scores"].numpy())
    np.testing.assert_array_equal(m > 0, sel == 1.0)
    assert float(diag["margin_gap"]) == pytest.approx(
        float(scores[1] - scores[0]))
    assert float(m[np.argmax(sel)]) == float(diag["margin_gap"])


def test_krum_margin_identity_masked_weighted():
    """Dead rows at -inf; weights scale the aggregate, never the
    margins."""
    G = _t(_grads(11, 30, seed=3))
    mask = _t(np.array([True] * 8 + [False] * 3))
    w = _t(np.linspace(0.5, 1.5, 11).astype(np.float32))
    agg, diag = K.krum(G, 11, 2, telemetry=True, margins=True, mask=mask)
    aggw, diagw = K.krum(G, 11, 2, telemetry=True, margins=True,
                         mask=mask, weights=w)
    for d in (diag, diagw):
        m, sel = d["margin_selection"].numpy(), d["selection_mask"].numpy()
        assert np.all(m[8:] == -np.inf)
        np.testing.assert_array_equal(m > 0, sel == 1.0)
    assert torch.equal(diag["margin_selection"], diagw["margin_selection"])
    winner = int(torch.argmax(diag["selection_mask"]))
    assert torch.equal(aggw, agg * w[winner])


@pytest.mark.parametrize("route", ["fused", "masked"])
def test_identical_colluders_tie_lock_at_exact_zero(route):
    """ALIE's identical crafted rows score bit-equal, so the winning
    colluder's margin is exactly 0.0 (one-sided: selected, margin not >
    0), on the fused score route and on the masked sort route."""
    n, f = 19, 6
    G = _t(_grads(n, 4099, seed=5, f=f))
    kw = ({"method": "fused"} if route == "fused"
          else {"mask": torch.ones(n, dtype=torch.bool)})
    _, diag = K.krum(G, n, f, telemetry=True, margins=True, numerics=True,
                     **kw)
    scores = diag["scores"][:f]
    assert torch.unique(scores).numel() == 1
    winner = int(torch.argmax(diag["selection_mask"]))
    assert winner == 0
    assert float(diag["margin_selection"][0]) == 0.0
    assert float(diag["margin_gap"]) == 0.0
    assert int(diag["num_tie_rows"]) >= f


def test_trimmed_mean_margin_kept_frac_bit_equal():
    """``margin_kept_frac`` is bit-equal to the kept fraction of the JAX
    package's XLA route on the same matrix (its own ``kept_fraction`` is
    NaN: the kernel returns only the aggregate), ties included."""
    for seed, G in ((1, _grads(13, 50, seed=1)),
                    (2, _grads(20, 257, seed=2, f=6))):
        n = G.shape[0]
        _, jd = JDEFENSES["TrimmedMean"](jnp.asarray(G), n, 3,
                                          telemetry=True)
        _, td = K.trimmed_mean(_t(G), n, 3, telemetry=True, margins=True)
        np.testing.assert_array_equal(td["margin_kept_frac"].numpy(),
                                      np.asarray(jd["kept_fraction"]))
        assert torch.isnan(td["kept_fraction"]).all()
        assert torch.isfinite(td["margin_boundary_dist"]).all()


def test_trimmed_mean_margin_masked():
    """Dead rows: zero kept fraction, -inf boundary distance; the alive
    rows keep e - f - 1 of the e alive values."""
    mask = _t(np.array([True] * 9 + [False] * 3))
    _, diag = K.trimmed_mean(_t(_grads(12, 40, seed=2)), 12, 2,
                             telemetry=True, margins=True, mask=mask)
    kf = diag["margin_kept_frac"].numpy()
    assert np.all(kf[9:] == 0.0)
    assert np.all(diag["margin_boundary_dist"].numpy()[9:] == -np.inf)
    assert np.sum(kf) == pytest.approx(6.0, rel=1e-6)


def test_median_margin_reconstructs_aggregate():
    """The pick masses reconstruct the median: unmasked (0.5 / 0.5 on the
    two middles of an even count) and masked and weighted (one pick a
    coordinate, the lower weighted median)."""
    G = _grads(12, 40, seed=4)
    agg, diag = DEFENSES["Median"](_t(G), 12, 2, telemetry=True,
                                   margins=True)
    picks = M.median_pick_margins(_t(G))
    assert torch.equal(diag["margin_kept_frac"], picks["margin_kept_frac"])
    vals = np.sort(G, axis=0)
    np.testing.assert_array_equal(agg.numpy(), (vals[5] + vals[6]) * 0.5)
    mask = np.array([True] * 9 + [False] * 3)
    w = (2.0 ** -(np.arange(12) % 3)).astype(np.float32)
    aggw, diagw = DEFENSES["Median"](_t(G), 12, 2, telemetry=True,
                                     margins=True, mask=_t(mask),
                                     weights=_t(w))
    kf = diagw["margin_kept_frac"].numpy()
    assert np.all(kf[~mask] == 0.0)
    np.testing.assert_allclose(kf.sum(), 1.0, rtol=1e-6)
    assert np.all(diagw["margin_boundary_dist"].numpy()[~mask] == -np.inf)
    # The pick is an alive row's value in every column.
    hits = (G == aggw.numpy()[None, :]) & mask[:, None]
    assert (hits.sum(0) >= 1).all()


@pytest.mark.parametrize("masked", [False, True], ids=["clear", "mask"])
def test_bulyan_margin_identity(masked):
    """Strictly positive margin implies selected; alive unselected rows
    sit at margin <= 0; dead rows at -inf; trim survival only on picks;
    one slack a trip."""
    G = _t(_grads(15, 40, seed=5 + masked))
    kw = {"mask": _t(np.array([True] * 11 + [False] * 4))} if masked else {}
    _, diag = K.bulyan(G, 15, 2, telemetry=True, margins=True, **kw)
    m = diag["margin_selection"].numpy()
    sel = diag["selection_mask"].numpy()
    tk = diag["margin_trim_kept"].numpy()
    alive = np.arange(15) < (11 if masked else 15)
    assert np.all(sel[m > 0] == 1.0)
    assert np.all(m[alive & (sel == 0.0)] <= 0.0)
    assert np.all(m[~alive] == -np.inf)
    assert np.all(tk[sel == 0.0] == 0.0)
    assert np.all(tk[sel == 1.0] > 0.0)
    assert diag["margin_slack"].shape == (15 - 4,)


@pytest.mark.parametrize("q", [1, 3])
def test_bulyan_margin_loop_picks_the_margins_off_selection(q):
    """The margin carries ride one ranking a trip whose first picks are
    the loop's without margins, ties included (identical rows)."""
    G = _t(_grads(23, 64, seed=9, f=7))
    D = K.distances_for(G)
    plain = K.bulyan_select(D, 23, 3, batch_select=q)
    sel, carry = K.bulyan_select(D, 23, 3, batch_select=q, margins=True)
    assert torch.equal(plain, sel)
    assert carry["slack"].shape == (-(-(23 - 6) // q),)


def _ties(n, d, seed):
    """Columns of small integers: exact ties everywhere."""
    rng = np.random.default_rng(seed)
    return rng.integers(-3, 4, (n, d)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_device_reductions_match_jax(seed):
    """krum_margins, rank_keep_margins and median_pick_margins on the same
    inputs as JAX's, on tie-heavy matrices: ranks, kept fractions and
    picks exactly; boundary distances within 2e-6 of their scale."""
    n, d = 16, 33
    G = _ties(n, d, seed)
    scores = np.round(np.random.default_rng(seed).normal(size=n), 1)
    scores = scores.astype(np.float32)
    idx = int(np.argmin(scores))
    mask = np.random.default_rng(seed + 1).random(n) < 0.8
    for mk in (None, mask):
        jm = JM.krum_margins(jnp.asarray(scores), idx,
                             None if mk is None else jnp.asarray(mk))
        tm = M.krum_margins(_t(scores), idx, None if mk is None else _t(mk))
        for k in jm:
            np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]))
    key = np.abs(G - np.median(G, 0)).astype(np.float32)
    key[~mask] = np.inf
    for k in (5, 9):
        jr = JM.rank_keep_margins(jnp.asarray(key), k)
        tr = M.rank_keep_margins(_t(key), k)
        np.testing.assert_array_equal(tr["margin_kept_frac"].numpy(),
                                      np.asarray(jr["margin_kept_frac"]))
        np.testing.assert_allclose(tr["margin_boundary_dist"].numpy(),
                                   np.asarray(jr["margin_boundary_dist"]),
                                   rtol=2e-6, atol=1e-7)
    w = (2.0 ** -np.random.default_rng(seed).integers(0, 3, n)).astype(
        np.float32)
    for kw in ({}, {"mask": mask}, {"mask": mask, "weights": w}):
        jp = JM.median_pick_margins(jnp.asarray(G), **{
            k: jnp.asarray(v) for k, v in kw.items()})
        tp = M.median_pick_margins(_t(G), **{k: _t(v)
                                             for k, v in kw.items()})
        np.testing.assert_array_equal(tp["margin_kept_frac"].numpy(),
                                      np.asarray(jp["margin_kept_frac"]))
        np.testing.assert_allclose(tp["margin_boundary_dist"].numpy(),
                                   np.asarray(jp["margin_boundary_dist"]),
                                   rtol=2e-6, atol=1e-7)


def test_stable_argsort_is_jax_order():
    """Ties by row index, -0.0 equal to 0.0, NaN last: JAX's stable
    argsort on the same column."""
    x = np.array([[0.0], [-0.0], [np.nan], [-1.0], [np.inf], [-np.inf],
                  [1.0], [0.0], [-np.nan], [2.0]], np.float32)
    got = M.stable_argsort(_t(x)).numpy()
    want = np.asarray(jnp.argsort(jnp.asarray(x), axis=0, stable=True))
    np.testing.assert_array_equal(got, want)


def test_margins_require_telemetry():
    """The seam guards' messages are JAX's."""
    with pytest.raises(ValueError) as want:
        jax_check_margin_seam(True, False)
    for name in ("Krum", "TrimmedMean", "Median", "Bulyan", "NoDefense"):
        with pytest.raises(ValueError) as got:
            DEFENSES[name](_t(_grads(15, 8)), 15, 2, margins=True)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("defense", ["NoDefense", "DnC", "GeoMedian",
                                     "CenteredClip", "FLTrust",
                                     "NormBound"])
def test_config_rejects_non_margin_defenses(defense):
    with pytest.raises(ValueError) as want:
        JConfig(defense=defense, margins=True)
    with pytest.raises(ValueError) as got:
        ExperimentConfig(defense=defense, margins=True)
    assert str(got.value) == str(want.value)


def _fields(seed, n=12, stacked=None):
    rng = np.random.default_rng(seed)
    shape = (n,) if stacked is None else (stacked, n)
    sel = rng.normal(size=shape).round(1)
    sel.flat[::5] = 0.0
    sel.flat[1] = -np.inf
    return {"margin_selection": sel.tolist(),
            "margin_kept_frac": rng.random(shape).tolist(),
            "margin_boundary_dist": rng.normal(size=shape).tolist(),
            "margin_gap": 0.5 if stacked is None else [0.5] * stacked}


def test_margin_rollups_units():
    """margin_rollups, hier_margin_rollups and tier2_margin_rollups equal
    the JAX package's on the same fields."""
    for seed in range(4):
        f = _fields(seed)
        for mal in (0, 3):
            assert M.margin_rollups(f, mal) == JM.margin_rollups(f, mal)
        no_sel = {k: v for k, v in f.items() if k != "margin_selection"}
        assert M.margin_rollups(no_sel, 3) == JM.margin_rollups(no_sel, 3)
        st = _fields(seed, stacked=4)
        counts = [2, 0, 1, 3]
        assert (M.hier_margin_rollups(st, counts)
                == JM.hier_margin_rollups(st, counts))
        shards = [True, False, True, False, False, True, False, True,
                  False, False, True, False]
        assert (M.tier2_margin_rollups(f, shards)
                == JM.tier2_margin_rollups(f, shards))


def test_margin_series_and_drift():
    events = [{"kind": "margin", "round": r, "defense": d,
               "colluder_margin": v, "colluder_selected": r % 2}
              for r, (d, v) in enumerate([("Krum", 0.5), ("Krum", -0.1),
                                          ("Bulyan", 0.0), ("Krum", 0.2)])]
    events.append({"kind": "eval", "round": 1})
    got, want = M.margin_series(events), JM.margin_series(events)
    assert got == want
    other = {"round": [0, 1, 3], "colluder_margin": [-0.5, -0.1, None]}
    assert (M.margin_drift(got["Krum"], other)
            == JM.margin_drift(want["Krum"], other))
    assert M.MARGIN_KEYS == JM.MARGIN_KEYS


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """The port on two intra-op threads, for speed: beside the other test
    workers, a machine's every core per worker spins more than it
    computes.  Each engine pair here runs at the same setting, and the
    margins are held to JAX's within bands."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ds():
    return O.datasets()


@pytest.mark.parametrize("defense", ["Krum", "TrimmedMean"])
def test_faulted_margin_events_match_the_jax_engine(defense, ds, tmp_path):
    """Faulted rounds with --margins and --numerics alone (no defense
    events): 'margin' and 'numerics' events against the JAX engine's."""
    jexp, texp = O.pair(ds, faults=dict(dropout=0.15, straggler=0.15,
                                        straggler_delay=1, corrupt=0.1),
                        defense=defense, margins=True, numerics=True)
    jev, tev = O.run_events(jexp, texp, tmp_path)
    O.compare_events(jev, tev, ["fault", "margin", "numerics"])
    assert "defense" not in O.by_kind(tev)


def test_margin_events_join_traffic_f_eff(ds, tmp_path):
    """A traffic run's 'margin' event carries the round's effective f,
    and the stream equals the JAX engine's."""
    jexp, texp = O.pair(ds, traffic=dict(population=32, rate=0.65, seed=1),
                        defense="Krum", epochs=3, margins=True,
                        telemetry=True)
    jev, tev = O.run_events(jexp, texp, tmp_path)
    O.compare_events(jev, tev, ["margin", "traffic", "defense"])
    assert all("f_eff" in e for e in O.by_kind(tev)["margin"])


@pytest.mark.parametrize("defense,weighting", [("Krum", "poly"),
                                               ("Median", "const")])
def test_async_margin_events_match_the_jax_engine(defense, weighting, ds,
                                                  tmp_path):
    """Async rounds (k = 9): margins over the delivered cohort, round 0's
    empty delivery included, against the JAX engine's."""
    jexp, texp = O.pair(ds, defense=defense, epochs=3,
                        aggregation="async", async_buffer=9,
                        staleness_weight=weighting, margins=True,
                        telemetry=True)
    jev, tev = O.run_events(jexp, texp, tmp_path)
    O.compare_events(jev, tev, ["async", "margin", "defense", "attack"])


def test_bulyan_margin_collapse_signature():
    """The science gate's pair on the port (CPU): Bulyan at z = 1.5, n =
    19, SYNTH_MNIST_HARD 4,000 / 1,000, 30 rounds, --margins, IID and
    femnist_style at style strength 0.5; ``margin_tie_rounds`` and
    ``colluder_selected_total`` inside BEHAVIOR_BASELINE.json's bands."""
    with open(os.path.join(ROOT, "BEHAVIOR_BASELINE.json")) as fh:
        cells = json.load(fh)["cells"]
    hard = load_dataset(C.SYNTH_MNIST_HARD, seed=0, synth_train=4000,
                        synth_test=1000)
    for cell, extra in (("bulyan_margin_collapse", {}),
                        ("bulyan_margin_rescue",
                         dict(partition="femnist_style",
                              style_strength=0.5))):
        cfg = ExperimentConfig(
            dataset=C.SYNTH_MNIST_HARD, users_count=19, mal_prop=0.2,
            batch_size=64, epochs=30, test_step=15, seed=0,
            synth_train=4000, synth_test=1000, defense="Bulyan",
            num_std=1.5, margins=True, **extra)
        exp = FederatedExperiment(cfg, DriftAttack(1.5), hard,
                                  device="cpu")
        logger = RunLogger(cfg, log_dir=None, log=lambda s: None)
        exp.run(logger)
        rows = [e for e in logger.events if e["kind"] == "margin"]
        cms = [e["colluder_margin"] for e in rows]
        got = {"margin_tie_rounds": sum(1 for v in cms if v == 0.0),
               "colluder_selected_total": sum(e["colluder_selected"]
                                              for e in rows)}
        for k, v in got.items():
            band = cells[cell][k]
            assert abs(v - band["value"]) <= band["band"], (cell, k, v,
                                                             band)
