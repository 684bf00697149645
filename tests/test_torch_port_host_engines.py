"""The host engines: the six ``*_impl`` knobs, the native library and the
host kernels of the port against the JAX package's.

- The port's native library (native/bulyan_select.cpp, built here with
  g++) and its NumPy plain versions (defenses/host.py) against the JAX
  package's ``defenses/host.py`` and ``native`` on the same seeded numpy
  inputs: Krum's index, the median, the trimmed mean, Bulyan's selection
  at batch_select 1 and 4 and under paper scoring, with and without ties.
- The config's accept/refuse matrix over the nine fields of this slice,
  each refusal with the JAX package's message, and the CLI's flags.
- Three flat rounds of the port's engine with each 'host' knob against
  the JAX engine with the same knob (weights and velocity within atol
  1e-5, as tests/test_torch_port_round.py holds them; the selections
  equal every round).
- The hierarchical, traffic, fault (mask) and margins refusals, and the
  loader's: a failed build raises.
"""

import numpy as np
import pytest
import torch

from attacking_federate_learning_tpu import cli as jax_cli
from attacking_federate_learning_tpu import config as JC
from attacking_federate_learning_tpu import native as JN
from attacking_federate_learning_tpu.attacks import DriftAttack as JDrift
from attacking_federate_learning_tpu.config import (
    ExperimentConfig as JConfig, FaultConfig as JFaultConfig,
    TrafficConfig as JTrafficConfig
)
from attacking_federate_learning_tpu.core.engine import (
    FederatedExperiment as JExperiment
)
from attacking_federate_learning_tpu.data.datasets import (
    load_dataset as jax_load_dataset
)
from attacking_federate_learning_tpu.defenses import host as JH
from attacking_federate_learning_tpu_torch import cli
from attacking_federate_learning_tpu_torch import config as C
from attacking_federate_learning_tpu_torch import native as N
from attacking_federate_learning_tpu_torch.attacks import DriftAttack
from attacking_federate_learning_tpu_torch.config import (
    ExperimentConfig, FaultConfig, TrafficConfig
)
from attacking_federate_learning_tpu_torch.core.engine import (
    FederatedExperiment
)
from attacking_federate_learning_tpu_torch.core.server import (
    init_server_state
)
from attacking_federate_learning_tpu_torch.data.datasets import load_dataset
from attacking_federate_learning_tpu_torch.defenses import DEFENSES
from attacking_federate_learning_tpu_torch.defenses import host as H
from attacking_federate_learning_tpu_torch.defenses import kernels as K
from attacking_federate_learning_tpu_torch.ops import _build
from attacking_federate_learning_tpu_torch.utils.weights import (
    from_jax_params
)

N_ROUND, MAL_PROP, B, ROUNDS = 19, 0.22, 32, 3
SIZES = dict(synth_train=1200, synth_test=300)

# The nine fields of this slice, with the JAX package's defaults.
FIELDS = {"distance_impl": "auto", "bulyan_selection_impl": "xla",
          "aggregation_impl": "xla", "bulyan_trim_impl": "xla",
          "trimmed_mean_impl": "xla", "median_impl": "xla",
          "data_placement": "device", "stream_prefetch": 1,
          "stream_workers": 0}


def _matrix(n, d, seed, ties=False):
    """A seeded (n, d) f32 update matrix; with ``ties`` whole rows
    repeat (equal distances, equal scores) and coordinates repeat
    values (equal deviations at the trim boundary)."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, d)).astype(np.float32)
    if ties:
        G[1::3] = G[0]
        G[:, ::2] = np.round(G[:, ::2])
    return G


def _jax_native_loaded():
    return JN.get_lib() is not None


# ---------------------------------------------------------------------------
# the host kernels against the JAX package's

@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("paper", [False, True])
@pytest.mark.parametrize("n,f", [(19, 4), (40, 9)])
def test_krum_index_is_jax_s(n, f, paper, ties):
    G = _matrix(n, 257, seed=n + f, ties=ties)
    want = JH.host_krum_index(G, n, f, paper_scoring=paper)
    assert H.host_krum_index(G, n, f, paper_scoring=paper) == want
    got = K.host_krum_select(torch.from_numpy(G), n, f, paper)
    assert got == want


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n,d", [(1, 9), (2, 130), (19, 257), (40, 1000)])
def test_native_median_is_jax_s(n, d, ties):
    G = _matrix(n, d, seed=3 * n + d, ties=ties)
    got = N.native_median(G)
    np.testing.assert_array_equal(got, JH.host_median(G))
    np.testing.assert_array_equal(got, np.median(G, 0).astype(np.float32))
    np.testing.assert_array_equal(H.host_median(G), got)


def test_host_median_of_a_non_finite_matrix_is_numpy_s():
    G = _matrix(9, 40, seed=1)
    G[3, 5], G[4, 7] = np.nan, np.inf
    got = H.host_median(G)
    np.testing.assert_array_equal(got, JH.host_median(G))
    assert np.isnan(got[5]) and np.isfinite(np.delete(got, 5)).all()


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n,k,d", [(19, 14, 257), (11, 6, 130), (40, 1, 70),
                                   (40, 40, 70), (5, 2, 1000)])
def test_native_trimmed_mean_is_jax_s(n, k, d, ties):
    G = _matrix(n, d, seed=n * k + d, ties=ties)
    got = N.native_trimmed_mean(G, k)
    np.testing.assert_array_equal(got, JH.host_trimmed_mean_of(G, k))
    np.testing.assert_array_equal(H.host_trimmed_mean_of(G, k), got)
    # The NumPy formulation, the plain version: summation-order ulps.
    med = np.median(G, 0)
    dev = G - med
    order = np.argsort(np.abs(dev), axis=0, kind="stable")
    plain = np.take_along_axis(dev, order[:k], 0).mean(0) + med
    np.testing.assert_allclose(got, plain, rtol=0, atol=4e-7 * np.abs(
        G).max())


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("paper", [False, True])
@pytest.mark.parametrize("q", [1, 4])
@pytest.mark.parametrize("n,f", [(19, 4), (43, 10)])
def test_bulyan_selection_is_jax_s(n, f, q, paper, ties):
    G = _matrix(n, 129, seed=7 * n + q, ties=ties)
    D = H.host_pairwise_distances(G)
    np.testing.assert_array_equal(D, JH.host_pairwise_distances(G))
    set_size = n - 2 * f
    got = H.host_bulyan_selection(D, n, f, set_size, batch_select=q,
                                  paper_scoring=paper)
    want = JH.host_bulyan_selection(D, n, f, set_size, batch_select=q,
                                    paper_scoring=paper)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and len(set(got.tolist())) == set_size
    # The plain version, JAX's NumPy loop and the port's copy of it.
    order = np.argsort(D, axis=1).astype(np.int32)
    plain = H.numpy_bulyan_selection(D, order, n, f, set_size,
                                     batch_select=q, paper_scoring=paper)
    np.testing.assert_array_equal(plain, JH.numpy_bulyan_selection(
        D, order, n, f, set_size, batch_select=q, paper_scoring=paper))
    np.testing.assert_array_equal(got, plain)
    if _jax_native_loaded():
        np.testing.assert_array_equal(N.native_bulyan_selection(
            D, order, n, f, set_size, q, paper), JN.native_bulyan_selection(
            D, order, n, f, set_size, q, paper))


@pytest.mark.parametrize("q", [1, 3])
def test_host_bulyan_is_jax_s(q):
    G = _matrix(23, 300, seed=q)
    np.testing.assert_array_equal(H.host_bulyan(G, 23, 5, batch_select=q),
                                  JH.host_bulyan(G, 23, 5, batch_select=q))


def test_native_calls_refuse_what_the_library_refuses():
    with pytest.raises(ValueError, match="set_size"):
        N.native_bulyan_selection(np.zeros((3, 3), np.float32),
                                  np.zeros((3, 3), np.int32), 3, 0, 4)
    with pytest.raises(ValueError, match="0 < k <= n"):
        N.native_trimmed_mean(np.zeros((3, 4), np.float32), 0)
    with pytest.raises(ValueError, match="empty"):
        N.native_median(np.zeros((0, 4), np.float32))
    # An order with an out-of-range column: the library's nonzero status.
    bad = np.full((3, 3), 7, np.int32)
    with pytest.raises(RuntimeError, match="fl_bulyan_select failed"):
        N.native_bulyan_selection(np.zeros((3, 3), np.float32), bad, 3, 0, 3)


# ---------------------------------------------------------------------------
# the defenses' host routes against their device routes

@pytest.mark.parametrize("name,kw", [
    ("Krum", dict(distance_impl="host")),
    ("Bulyan", dict(selection_impl="host")),
    ("Bulyan", dict(selection_impl="host", trim_impl="host")),
    ("Bulyan", dict(selection_impl="host", batch_select=4)),
    ("Bulyan", dict(distance_impl="host")),
    ("TrimmedMean", dict(impl="host")),
    ("Median", dict(impl="host"))],
    ids=["krum", "hybrid", "hybrid-trim", "hybrid-q4", "full-host", "trim",
         "median"])
def test_host_routes_match_the_device_routes(name, kw):
    G = torch.from_numpy(_matrix(19, 500, seed=5))
    got, diag = DEFENSES[name](G, 19, 4, **kw, telemetry=True)
    dev_kw = {"batch_select": kw["batch_select"]} if "batch_select" in kw \
        else {}
    want, wdiag = DEFENSES[name](G, 19, 4, **dev_kw, telemetry=True)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    if kw.get("distance_impl") == "host":
        assert torch.isnan(diag["scores"]).all()
        if name == "Krum":
            assert torch.equal(diag["selection_mask"],
                               wdiag["selection_mask"])
    elif "selection_mask" in diag:
        assert torch.equal(diag["selection_mask"], wdiag["selection_mask"])
        assert torch.equal(diag["scores"], wdiag["scores"])


@pytest.mark.parametrize("name,kw,msg", [
    ("Krum", dict(distance_impl="host", mask=True),
     "mask-aware Krum needs a score-returning engine"),
    ("Krum", dict(distance_impl="host", telemetry=True, margins=True),
     "Krum margins need a score-returning engine"),
    ("Bulyan", dict(selection_impl="host", mask=True),
     "mask-aware Bulyan is incompatible with selection_impl='host'"),
    ("Bulyan", dict(distance_impl="host", mask=True),
     "mask-aware Bulyan has no full-host engine"),
    ("Bulyan", dict(distance_impl="host", telemetry=True, margins=True),
     "Bulyan margins need the traced selection loop"),
    ("Bulyan", dict(selection_impl="host", telemetry=True, margins=True),
     "Bulyan margins are incompatible with selection_impl='host'"),
    ("TrimmedMean", dict(impl="host", mask=True),
     "mask-aware TrimmedMean has no host kernel"),
    ("TrimmedMean", dict(impl="host", telemetry=True, margins=True),
     "trimmed-mean margins need the on-device ranks"),
    ("Median", dict(impl="host", mask=True),
     "mask-aware Median has no host kernel"),
    ("Median", dict(impl="host", telemetry=True, margins=True),
     "Median margins need the on-device ranks")])
def test_host_routes_refuse_what_they_cannot_see(name, kw, msg):
    G = torch.from_numpy(_matrix(19, 40, seed=2))
    if kw.pop("mask", False):
        kw["mask"] = torch.ones(19, dtype=torch.bool)
    with pytest.raises(ValueError, match=msg.replace("(", r"\(")):
        DEFENSES[name](G, 19, 4, **kw)


def test_the_hybrid_hands_the_native_selection_an_inf_diagonal(
        monkeypatch):
    seen = []
    inner = H.host_bulyan_selection

    def spy(D, *a, **kw):
        seen.append(np.diag(D).copy())
        return inner(D, *a, **kw)

    monkeypatch.setattr(H, "host_bulyan_selection", spy)
    G = torch.from_numpy(_matrix(19, 60, seed=4))
    DEFENSES["Bulyan"](G, 19, 4, selection_impl="host")
    assert len(seen) == 1 and np.isposinf(seen[0]).all()


# ---------------------------------------------------------------------------
# the config and the CLI

def test_the_nine_fields_have_jax_s_defaults():
    t, j = ExperimentConfig(), JConfig()
    for name, default in FIELDS.items():
        assert getattr(t, name) == getattr(j, name) == default, name
    import dataclasses
    missing = ({f.name for f in dataclasses.fields(JConfig)}
               - {f.name for f in dataclasses.fields(ExperimentConfig)})
    assert missing == {"backend"}


_ACCEPT = [
    dict(distance_impl="host", defense="Krum"),
    dict(distance_impl="xla", defense="Bulyan"),
    dict(distance_impl="pallas", defense="Krum"),
    dict(distance_impl="ring", defense="Krum"),
    dict(bulyan_selection_impl="host", defense="Bulyan"),
    dict(bulyan_selection_impl="pallas", defense="Bulyan"),
    dict(bulyan_trim_impl="host", defense="Bulyan"),
    dict(trimmed_mean_impl="host", defense="TrimmedMean"),
    dict(median_impl="host", defense="Median"),
    dict(aggregation_impl="pallas", defense="Krum"),
    dict(aggregation_impl="pallas", defense="Bulyan",
         bulyan_selection_impl="pallas", distance_impl="pallas"),
    dict(data_placement="host_stream", stream_prefetch=3, stream_workers=1),
    dict(trimmed_mean_impl="host", defense="TrimmedMean", telemetry=True),
    dict(trimmed_mean_impl="host", defense="NoDefense", numerics=True),
]
_REFUSE = [
    dict(distance_impl="gpu"),
    dict(bulyan_selection_impl="cuda"),
    dict(aggregation_impl="host"),
    dict(bulyan_trim_impl="pallas"),
    dict(trimmed_mean_impl="pallas"),
    dict(median_impl="cuda"),
    dict(data_placement="hbm"),
    dict(stream_prefetch=0),
    dict(stream_workers=2),
    dict(aggregation_impl="pallas", defense="NoDefense"),
    dict(aggregation_impl="pallas", defense="DnC"),
    dict(aggregation_impl="pallas", defense="TrimmedMean",
         trimmed_mean_impl="host"),
    dict(aggregation_impl="pallas", defense="Median", median_impl="host"),
    dict(aggregation_impl="pallas", defense="Bulyan",
         bulyan_trim_impl="host"),
    dict(aggregation_impl="pallas", defense="Bulyan",
         bulyan_selection_impl="host"),
    dict(aggregation_impl="pallas", defense="Krum", distance_impl="xla"),
    dict(aggregation_impl="pallas", defense="Krum", distance_impl="host"),
    dict(aggregation_impl="pallas", defense="Krum", backdoor="pattern",
         backdoor_fused=False),
    dict(bulyan_selection_impl="pallas", defense="Bulyan",
         distance_impl="host"),
    dict(bulyan_selection_impl="pallas", defense="Bulyan",
         distance_impl="ring"),
    dict(margins=True, defense="Krum", distance_impl="host"),
    dict(margins=True, defense="TrimmedMean", trimmed_mean_impl="host"),
    dict(margins=True, defense="Median", median_impl="host"),
    dict(margins=True, defense="Bulyan", bulyan_selection_impl="host"),
    dict(margins=True, defense="Bulyan", bulyan_trim_impl="host"),
    dict(numerics=True, defense="Bulyan", distance_impl="host"),
    dict(numerics=True, defense="Median", median_impl="host"),
]


@pytest.mark.parametrize("kw", _ACCEPT, ids=[str(i) for i in
                                             range(len(_ACCEPT))])
def test_the_config_accepts_what_jax_accepts(kw):
    got = ExperimentConfig(**kw)
    want = JConfig(**kw)
    for name in FIELDS:
        assert getattr(got, name) == getattr(want, name), name


@pytest.mark.parametrize("kw", _REFUSE, ids=[str(i) for i in
                                             range(len(_REFUSE))])
def test_the_config_refuses_with_jax_s_message(kw):
    with pytest.raises(ValueError) as je:
        JConfig(**kw)
    with pytest.raises(ValueError) as te:
        ExperimentConfig(**kw)
    assert str(te.value) == str(je.value)


_FLAGS = ("trimmed_mean_impl", "median_impl", "data_placement",
          "stream_prefetch", "stream_workers", "bulyan_selection_impl",
          "aggregation_impl", "bulyan_trim_impl", "distance_impl")


def _flag_actions(parser):
    return {a.dest: (a.option_strings, a.default, a.choices, a.help,
                     a.type)
            for a in parser._actions if a.dest in _FLAGS}


def test_the_nine_flags_are_jax_s():
    got = _flag_actions(cli.build_parser())
    assert sorted(got) == sorted(_FLAGS)
    assert got == _flag_actions(jax_cli.build_parser())


@pytest.mark.parametrize("argv", [
    [], ["--distance-impl", "host", "-d", "Krum"],
    ["-d", "Bulyan", "--bulyan-selection-impl", "host",
     "--bulyan-trim-impl", "host"],
    ["-d", "TrimmedMean", "--trimmed-mean-impl", "host"],
    ["-d", "Median", "--median-impl", "host",
     "--data-placement", "host_stream", "--stream-prefetch", "2",
     "--stream-workers", "1"],
    ["-d", "Krum", "--aggregation-impl", "pallas"]])
def test_the_cli_builds_jax_s_config(argv):
    got = cli.config_from_args(cli.build_parser().parse_args(argv))
    want = jax_cli.config_from_args(jax_cli.build_parser().parse_args(argv))
    for name in FIELDS:
        assert getattr(got, name) == getattr(want, name), name


# ---------------------------------------------------------------------------
# whole rounds against the JAX engine

@pytest.fixture(scope="module")
def datasets():
    return (jax_load_dataset(JC.SYNTH_MNIST_HARD, seed=0, **SIZES),
            load_dataset(C.SYNTH_MNIST_HARD, seed=0, **SIZES))


def _pair(defense, datasets, **knobs):
    kw = dict(dataset=C.SYNTH_MNIST_HARD, users_count=N_ROUND,
              mal_prop=MAL_PROP, batch_size=B, epochs=ROUNDS,
              defense=defense, telemetry=True, **SIZES, **knobs)
    jexp = JExperiment(JConfig(**kw), attacker=JDrift(1.5),
                       dataset=datasets[0])
    texp = FederatedExperiment(ExperimentConfig(**kw), DriftAttack(1.5),
                               datasets[1], device="cpu")
    params = jax_params(jexp)
    texp.state = init_server_state(from_jax_params(params))
    return jexp, texp


def jax_params(jexp):
    import jax
    return jax.tree.map(np.asarray, jexp.flat.unravel(jexp.state.weights))


_ROUNDS = [
    ("Krum", dict(distance_impl="host")),
    ("Bulyan", dict(bulyan_selection_impl="host")),
    ("Bulyan", dict(bulyan_selection_impl="host", bulyan_trim_impl="host")),
    ("Bulyan", dict(bulyan_selection_impl="host", bulyan_batch_select=4)),
    ("Bulyan", dict(bulyan_trim_impl="host")),
    ("Bulyan", dict(distance_impl="host")),
    ("TrimmedMean", dict(trimmed_mean_impl="host")),
    ("Median", dict(median_impl="host")),
]


@pytest.mark.parametrize("defense,knobs", _ROUNDS,
                         ids=[f"{d}-{'-'.join(k)}" for d, k in _ROUNDS])
def test_three_rounds_match_the_jax_engine(defense, knobs, datasets):
    jexp, texp = _pair(defense, datasets, **knobs)
    for t in range(ROUNDS):
        jexp.run_round(t)
        texp.run_round(t)
        jt, tt = jexp.last_round_telemetry, texp.last_round_telemetry
        assert ("defense_selection_mask" in tt) == (
            defense in ("Krum", "Bulyan"))
        if "defense_selection_mask" in tt:
            got = tt["defense_selection_mask"].numpy()
            want = np.asarray(jt["defense_selection_mask"])
            if np.isnan(want).all():
                assert np.isnan(got).all()
            else:
                np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(texp.state.weights.numpy(),
                               np.asarray(jexp.state.weights),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(texp.state.velocity.numpy(),
                               np.asarray(jexp.state.velocity),
                               rtol=0, atol=1e-5)


def test_host_routes_run_only_where_the_config_names_them(monkeypatch,
                                                          datasets):
    """Default knobs never reach a host engine; a host knob reaches its
    own alone."""
    calls = []
    for name in ("host_krum_index", "host_bulyan", "host_median",
                 "host_trimmed_mean_of", "host_bulyan_selection"):
        inner = getattr(H, name)

        def spy(*a, _inner=inner, _name=name, **kw):
            calls.append(_name)
            return _inner(*a, **kw)
        monkeypatch.setattr(H, name, spy)
    for defense in ("Krum", "Bulyan", "TrimmedMean", "Median"):
        _, texp = _pair(defense, datasets)
        texp.run_round(0)
    assert calls == []
    _, texp = _pair("Bulyan", datasets, bulyan_selection_impl="host")
    texp.run_round(0)
    assert calls == ["host_bulyan_selection"]


def test_the_cost_report_names_the_host_routes(datasets):
    _, texp = _pair("Bulyan", datasets, bulyan_selection_impl="host",
                    bulyan_trim_impl="host")
    ledger = texp.cost_report(span=1)
    assert ledger.errors == []
    rec = {r.name: r for r in ledger.records}["defense_Bulyan"]
    assert set(rec.kernels) == {"pairwise_distances",
                                "host_bulyan_selection", "host_trimmed_mean"}
    assert rec.kernels["host_bulyan_selection"]["unit"] == "host"
    assert rec.kernels["host_bulyan_selection"]["stages"] == {
        "tier1_aggregate": 1}


# ---------------------------------------------------------------------------
# refusals of the engine: hierarchical, traffic, faults, async, mesh

_ENGINE_REFUSALS = [
    dict(defense="Krum", aggregation="hierarchical", megabatch=5,
         distance_impl="host"),
    dict(defense="Krum", aggregation="hierarchical", megabatch=5,
         distance_impl="ring"),
    dict(defense="Bulyan", aggregation="hierarchical", megabatch=10,
         mal_prop=0.1, bulyan_selection_impl="host"),
    dict(defense="TrimmedMean", aggregation="hierarchical", megabatch=5,
         trimmed_mean_impl="host"),
    dict(defense="Median", aggregation="hierarchical", megabatch=5,
         median_impl="host"),
    dict(defense="Bulyan", aggregation="hierarchical", megabatch=10,
         mal_prop=0.1, bulyan_trim_impl="host"),
    dict(defense="Krum", distance_impl="host",
         traffic=dict(population=64)),
    dict(defense="TrimmedMean", trimmed_mean_impl="host",
         faults=dict(dropout=0.1)),
    dict(defense="Median", median_impl="host", faults=dict(dropout=0.1)),
    dict(defense="Krum", distance_impl="host", aggregation="async",
         async_buffer=12),
    dict(defense="Krum", distance_impl="ring"),
    dict(defense="Bulyan", mal_prop=0.1, distance_impl="allgather"),
]


@pytest.mark.parametrize("kw", _ENGINE_REFUSALS,
                         ids=[str(i) for i in range(len(_ENGINE_REFUSALS))])
def test_the_engine_refuses_with_jax_s_message(kw, datasets):
    kw = dict(kw)
    faults, traffic = kw.pop("faults", None), kw.pop("traffic", None)
    base = dict(dataset=C.SYNTH_MNIST_HARD, users_count=20,
                mal_prop=kw.pop("mal_prop", 0.2), batch_size=B, epochs=1,
                **SIZES, **kw)
    with pytest.raises(ValueError) as je:
        JExperiment(JConfig(**base,
                            faults=faults and JFaultConfig(**faults),
                            traffic=traffic and JTrafficConfig(**traffic)),
                    attacker=JDrift(1.0), dataset=datasets[0])
    with pytest.raises(ValueError) as te:
        FederatedExperiment(ExperimentConfig(
            **base, faults=faults and FaultConfig(**faults),
            traffic=traffic and TrafficConfig(**traffic)),
            DriftAttack(1.0), datasets[1], device="cpu")
    assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# the loader

def _fresh_build(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_LOADED", {})


def test_the_native_build_raises_without_a_compiler(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setattr(_build, "GXX", str(tmp_path / "no-g++"))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        N.native_median(np.ones((3, 4), np.float32))
    # No host route falls back: the defense raises too.
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        DEFENSES["Median"](torch.ones(3, 4), 3, 0, impl="host")
    assert not (tmp_path / "_build").exists() or not any(
        (tmp_path / "_build").iterdir())


def test_the_native_build_raises_when_the_compiler_fails(monkeypatch,
                                                        tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    monkeypatch.setattr(_build, "GXX", "false")
    with pytest.raises(RuntimeError, match="g\\+\\+ native/bulyan_select.cpp "
                                           "failed"):
        H.host_bulyan_selection(np.ones((5, 5), np.float32), 5, 1, 3)
    assert list((tmp_path / "_build").iterdir()) == []


def test_the_native_build_lands_in_build_dir(monkeypatch, tmp_path):
    _fresh_build(monkeypatch, tmp_path)
    path = _build.host_library_path("bulyan_select")
    assert path.parent == tmp_path / "_build" and not path.exists()
    out = N.native_median(np.arange(12, dtype=np.float32).reshape(3, 4))
    np.testing.assert_array_equal(out, [4, 5, 6, 7])
    assert path.exists() and list(path.parent.iterdir()) == [path]
    assert path.name.startswith("bulyan_select_")
