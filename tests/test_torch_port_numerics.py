"""The numerics observatory (utils/numerics.py) and the f64 oracle
(defenses/oracle.py) of the port against the JAX package.

The device counters on the same inputs as JAX's (counts exactly; log2
ranges and cancellation bits within 1e-5 bits, the CPU's and XLA's f32
log2 and sums), the ulp lattice and ``adjudicate``'s verdict taxonomy
bit for bit JAX's host functions, the stage attribution, rollups, series
and drift helpers, the oracles equal to JAX's on the same numpy inputs,
the kernels' tie and cancellation counters on one matrix, the seam
guard's message, and the 'numerics' event streams (a defense without
margins, Krum, the hierarchical Median/Median and async TrimmedMean)
against the JAX engine's (tests/_torch_port_observe.py's tolerances);
two runs of one seed give the same 'numerics' events.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from attacking_federate_learning_tpu.defenses import DEFENSES as JDEFENSES
from attacking_federate_learning_tpu.defenses import oracle as JO
from attacking_federate_learning_tpu.defenses.kernels import (
    check_numerics_seam as jax_check_numerics_seam
)
from attacking_federate_learning_tpu.utils import numerics as JN
from attacking_federate_learning_tpu_torch.defenses import DEFENSES
from attacking_federate_learning_tpu_torch.defenses import oracle as TO
from attacking_federate_learning_tpu_torch.utils import numerics as N
from attacking_federate_learning_tpu_torch.utils.metrics import RunLogger

import _torch_port_observe as O


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_nonfinite_count_and_mask():
    x = np.array([[1.0, np.inf, 2.0], [np.nan, 3.0, -np.inf]], np.float32)
    mask = np.array([True, False])
    for mk in (None, mask):
        got = N.nonfinite_count(_t(x), None if mk is None
                                else torch.from_numpy(mk))
        want = JN.nonfinite_count(jnp.asarray(x), None if mk is None
                                  else jnp.asarray(mk))
        assert got.dtype == torch.int32 and int(got) == int(want)
    assert int(N.nonfinite_count(_t(x))) == 3


def test_norm_dynamic_range_units():
    cases = [np.array([[4.0, 0.0], [1.0, 0.0]], np.float32),
             np.zeros((3, 2), np.float32),
             np.array([[np.inf, 0.0], [2.0, 0.0], [1.0, 0.0]], np.float32),
             np.random.default_rng(0).normal(size=(9, 4099)).astype(
                 np.float32)]
    for G in cases:
        for mk in (None, np.arange(G.shape[0]) % 3 != 1):
            got = N.norm_dynamic_range(
                _t(G), None if mk is None else torch.from_numpy(mk))
            want = JN.norm_dynamic_range(
                jnp.asarray(G), None if mk is None else jnp.asarray(mk))
            assert float(got) == pytest.approx(float(want), abs=1e-5)
    assert float(N.norm_dynamic_range(_t(cases[0]))) == pytest.approx(2.0)


def test_tie_proximity_bands_at_boundary_scale():
    band = N.TIE_BAND_ULPS * 2.0 ** -23
    m = np.array([band * 0.5, -band * 0.5, band * 4.0, np.inf, -np.inf],
                 np.float32)
    for scale in (1.0, 1e-3, 0.0, 37.5):
        assert int(N.tie_proximity(_t(m), scale)) == int(
            JN.tie_proximity(jnp.asarray(m), scale))
        assert float(N.ulp_at(scale)) == float(JN.ulp_at(scale))
    assert int(N.tie_proximity(_t(m), 1.0)) == 2
    assert float(N.ulp_at(0.0)) > 0.0
    key = np.array([[1.0, np.inf], [-3.5, 2.0]], np.float32)
    assert float(N.max_finite_abs(_t(key))) == float(
        JN.max_finite_abs(jnp.asarray(key)))


def test_cancellation_bits_units():
    for mt, mp in ((2.0 ** 20, 2.0 ** -4), (8.0, 8.0), (3.0, 1e-9),
                   (0.0, 0.0)):
        assert float(N.cancellation_bits(mt, mp)) == pytest.approx(
            float(JN.cancellation_bits(mt, mp)), abs=1e-5)
    assert float(N.cancellation_bits(2.0 ** 20, 2.0 ** -4)) == 24.0


def test_gram_cancellation_bits():
    D = np.array([[np.inf, 4.0, 16.0], [4.0, np.inf, 1.0],
                  [16.0, 1.0, np.inf]], np.float32)
    mask = np.array([True, True, False])
    assert float(N.gram_cancellation_bits(_t(D))) == 4.0
    assert float(N.gram_cancellation_bits(
        _t(D), torch.from_numpy(mask))) == 0.0
    assert float(N.gram_cancellation_bits(_t(np.zeros((3, 3))))) == 0.0
    G = np.random.default_rng(1).normal(size=(12, 300)).astype(np.float32)
    G[:4] = G[0]
    Dg = ((G[:, None] - G[None]) ** 2).sum(-1).astype(np.float32)
    np.fill_diagonal(Dg, np.inf)
    assert float(N.gram_cancellation_bits(_t(Dg))) == pytest.approx(
        float(JN.gram_cancellation_bits(jnp.asarray(Dg))), abs=1e-5)


def test_f32_ords_and_ulp_diff_lattice():
    """The lattice functions are JAX's host functions, bit for bit."""
    rng = np.random.default_rng(2)
    a = np.concatenate([rng.normal(size=50), [0.0, -0.0, np.inf, -np.inf,
                                              np.nan, 1e-45]]).astype(
        np.float32)
    b = a.copy()
    b[::3] = np.nextafter(b[::3], np.float32(np.inf))
    np.testing.assert_array_equal(N.f32_ords(a), JN.f32_ords(a))
    np.testing.assert_array_equal(N.ulp_diff(a, b), JN.ulp_diff(a, b))
    assert N.max_ulp(a, b) == JN.max_ulp(a, b)
    assert N.max_ulp(a, a) == (0, -1)
    assert int(N.ulp_diff([np.nan], [1.0])[0]) == 2 ** 31


def test_adjudicate_verdict_taxonomy():
    """Every verdict of the taxonomy, each record equal to JAX's."""
    oracle = np.array([1.0, 2.0, 3.0], np.float64)
    o32 = oracle.astype(np.float32)
    b = o32.copy()
    b[1] = np.nextafter(b[1], np.float32(10.0))
    far = o32.copy()
    far[0] = o32[0] * np.float32(1.5)
    a = o32.copy()
    a[2] = o32[2] * np.float32(1.5)
    cases = {"exact": (o32, o32), "tie_band": (o32, b),
             "a_closer": (o32, far), "b_closer": (far, o32),
             "split": (a, far)}
    for verdict, (x, y) in cases.items():
        rec = N.adjudicate(x, y, oracle)
        assert rec == JN.adjudicate(x, y, oracle)
        assert rec["verdict"] == verdict


def test_oracle_matches_the_jax_package_and_referees_adjudicate():
    """The port's NumPy oracles give the JAX package's results on the same
    f64 inputs, and referee the port's f32 defenses: Krum's and Bulyan's
    aggregates exact or within the tie band, the trimmed mean's within
    the band of the f64 truth."""
    rng = np.random.default_rng(3)
    G = rng.normal(size=(15, 64))
    for name in TO.NP_DEFENSES:
        np.testing.assert_array_equal(TO.NP_DEFENSES[name](G, 15, 3),
                                      JO.NP_DEFENSES[name](G, 15, 3))
    G32 = G.astype(np.float32)
    for name, f in (("Krum", 3), ("TrimmedMean", 3), ("Bulyan", 2)):
        got = DEFENSES[name](torch.from_numpy(G32), 15, f).numpy()
        ref = TO.NP_DEFENSES[name](G32.astype(np.float64), 15, f)
        rec = N.adjudicate(got, ref.astype(np.float32), ref, band_ulps=64)
        assert rec["verdict"] in ("exact", "tie_band"), (name, rec)


def test_stage_attribution_units():
    fields = ["nonfinite_pre", "range_log2", "nonfinite_post", "tie_rows",
              "cancel_bits", "nonfinite_agg", "shard_tie_rows",
              "tier2_cancel_bits", "attack_z_used", "margin_selection",
              "shard_attack_x", "unknown"]
    for f in fields:
        for kind in ("numerics", "margin"):
            assert N.stage_of(f, kind) == JN.stage_of(f, kind)
    pairs = [(1.0, np.nextafter(np.float32(1.0), np.float32(2.0)).item()),
             ([1.0, 2.0], [1.0, 2.5]), ("a", "b"), (True, 1.0)]
    for a, b in pairs:
        assert N.field_ulp(a, b) == JN.field_ulp(a, b)
    rec = {"tie_rows": [1, 3], "range_log2": [0.5, 0.5000001],
           "shard_tie_rows": [[1, 2], [1, 2]]}
    assert (N.divergence_attribution(rec)
            == JN.divergence_attribution(rec))


def test_numerics_rollups_series_and_drift():
    fields = {"nonfinite_pre": 2.0, "nonfinite_post": 1.0,
              "shard_nonfinite_pre": [1.0, 0.0, float("nan")],
              "tie_rows": 0.0, "shard_tie_rows": [0.0, 3.0],
              "range_log2": 1.5}
    assert N.numerics_rollups(fields) == JN.numerics_rollups(fields)
    events = [{"kind": "numerics", "round": r, "tie_rows": float(r % 2),
               "shard_cancel_bits": [1.0, 2.0 + r], "range_log2": 0.5}
              for r in (2, 0, 1)] + [{"kind": "eval", "round": 0}]
    assert N.numerics_series(events) == JN.numerics_series(events)
    other = N.numerics_series([dict(e, tie_rows=0.0) for e in events])
    a = N.numerics_series(events)
    assert N.numerics_drift(a, other) == JN.numerics_drift(a, other) == (
        1, 1.0, 0.0)
    assert N.numerics_drift(a, a) is None
    assert N.SERIES_FIELDS == JN.SERIES_FIELDS


def test_kernel_numerics_require_margins():
    with pytest.raises(ValueError) as want:
        jax_check_numerics_seam(True, False)
    for name in ("Krum", "TrimmedMean", "Median", "Bulyan", "NoDefense"):
        with pytest.raises(ValueError) as got:
            DEFENSES[name](_t(np.ones((15, 4))), 15, 2, telemetry=True,
                           numerics=True)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("masked", [False, True], ids=["clear", "mask"])
@pytest.mark.parametrize("name", ["Krum", "TrimmedMean", "Median",
                                  "Bulyan"])
def test_kernel_numerics_fields(name, masked):
    """The tie counters equal JAX's on one matrix (identical crafted rows
    make ties); Krum's cancellation estimate within 1e-5 bits; Bulyan's
    from the same distance matrix JAX's is measured on, within 1e-5."""
    n, f = 19, 3
    G = np.random.default_rng(4).normal(size=(n, 257)).astype(np.float32)
    G[:f] = G[:f].mean(0) - 1.5 * G[:f].std(0)
    mask = np.arange(n) % 5 != 4
    jkw = {"mask": jnp.asarray(mask)} if masked else {}
    tkw = {"mask": torch.from_numpy(mask)} if masked else {}
    _, jd = JDEFENSES[name](jnp.asarray(G), n, f, telemetry=True,
                            margins=True, numerics=True, **jkw)
    _, td = DEFENSES[name](_t(G), n, f, telemetry=True, margins=True,
                           numerics=True, **tkw)
    assert {k for k in jd if k.startswith("num_")} == {
        k for k in td if k.startswith("num_")}
    assert int(td["num_tie_rows"]) == int(jd["num_tie_rows"])
    if name == "Krum":
        assert float(td["num_cancel_bits"]) == pytest.approx(
            float(jd["num_cancel_bits"]), abs=1e-4)
    if name == "Bulyan":
        assert np.isfinite(float(td["num_cancel_bits"]))


@pytest.fixture(scope="module")
def ds():
    return O.datasets()


@pytest.mark.parametrize("kw", [
    dict(defense="NoDefense"), dict(defense="DnC"), dict(defense="Krum"),
    dict(defense="TrimmedMean", aggregation="async", async_buffer=9,
         staleness_weight="poly", epochs=3),
    dict(defense="Median", users_count=20, mal_prop=0.2,
         aggregation="hierarchical", megabatch=5, tier2_defense="Median")],
    ids=["NoDefense", "DnC", "Krum", "async-TrimmedMean",
         "hier-Median-Median"])
def test_numerics_events_match_the_jax_engine(kw, ds, tmp_path):
    """--numerics alone: the stage counters (and on a margin-bearing
    defense the kernel counters, with the margins carried but not
    emitted) against the JAX engine's 'numerics' events."""
    jexp, texp = O.pair(ds, numerics=True, **kw)
    jev, tev = O.run_events(jexp, texp, tmp_path)
    O.compare_events(jev, tev, ["numerics"])
    kinds = set(O.by_kind(tev))
    assert "margin" not in kinds and "defense" not in kinds


def test_same_seed_twins_are_bit_deterministic(ds):
    """Two runs of one seed emit the same 'numerics' events."""
    streams = []
    for _ in range(2):
        _, texp = O.pair(ds, defense="Bulyan", mal_prop=0.06, numerics=True,
                         faults=dict(dropout=0.15, corrupt=0.1))
        logger = RunLogger(texp.cfg, log_dir=None, log=lambda s: None)
        texp.run(logger)
        streams.append([{k: v for k, v in e.items() if k != "t"}
                        for e in logger.events if e["kind"] == "numerics"])
    assert streams[0] == streams[1] and len(streams[0]) == 2
