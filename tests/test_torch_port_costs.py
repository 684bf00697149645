"""The port's cost and wire ledgers (utils/costs.py) against the JAX
package's: the stage taxonomy and the wire seams equal, ``wire_ledger``
equal over the topologies, secagg modes and drops, the engines'
``wire_ledger()`` and ``_span_entry_name()`` equal the JAX engine's; the
counting mode: the aten model (matmul FLOPs from PyTorch's own formulas,
views free), each hand kernel's wrapper booking its modeled formula and
not its plain version's operations, stage sums plus ``unattributed``
equal to the totals; ``cost_report``: one 'cost' and one 'stage_cost'
event an entry point, valid under both packages' ``validate_event``,
no 'compile' event and no peak on the CPU, and the run after it
byte-equal to the run without it (flat clean, faulted with stragglers,
vanilla secagg, the backdoor and DnC; traffic; async; hierarchical clean
and under groupwise secagg)."""

import json
import math

import numpy as np
import pytest
import torch

from attacking_federate_learning_tpu.utils import costs as JC
from attacking_federate_learning_tpu.utils.metrics import (
    validate_event as jax_validate_event
)
from attacking_federate_learning_tpu_torch.attacks import (
    DriftAttack, make_attacker
)
from attacking_federate_learning_tpu_torch.config import (
    ExperimentConfig, FaultConfig, TrafficConfig
)
from attacking_federate_learning_tpu_torch.core.engine import (
    FederatedExperiment
)
from attacking_federate_learning_tpu_torch.data.datasets import load_dataset
from attacking_federate_learning_tpu_torch.ops import _build
from attacking_federate_learning_tpu_torch.ops import defense_kernels as DK
from attacking_federate_learning_tpu_torch.ops import secagg_masks as SM
from attacking_federate_learning_tpu_torch.ops import threefry_bits as TB
from attacking_federate_learning_tpu_torch.ops.distances import (
    pairwise_distances, pairwise_distances_cost
)
from attacking_federate_learning_tpu_torch.protocols import secagg as SA
from attacking_federate_learning_tpu_torch.utils import costs as C
from attacking_federate_learning_tpu_torch.utils import threefry
from attacking_federate_learning_tpu_torch.utils.metrics import (
    RunLogger, validate_event
)

from _torch_port_observe import datasets, pair

SMALL = dict(dataset="SYNTH_MNIST", users_count=12, mal_prop=0.25,
             batch_size=16, epochs=4, test_step=2, synth_train=400,
             synth_test=100)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def small_ds():
    return load_dataset("SYNTH_MNIST", seed=0, synth_train=400,
                        synth_test=100)


@pytest.fixture(scope="module")
def jax_pair_ds():
    return datasets()


def test_stages_and_seams_are_jax_s():
    assert C.STAGES == JC.STAGES
    assert C.WIRE_SEAMS == JC.WIRE_SEAMS


@pytest.mark.parametrize("topology", ["flat", "async", "hierarchical"])
@pytest.mark.parametrize("secagg", ["off", "vanilla", "groupwise"])
@pytest.mark.parametrize("dropped", [0, 3])
def test_wire_ledger_equals_jax(topology, secagg, dropped):
    kw = dict(cohort=40, dim=79_510, grad_bytes=2 if dropped else 4,
              topology=topology, secagg=secagg, dropped=dropped)
    if topology == "hierarchical":
        kw.update(num_shards=4, megabatch=10, spmd_parts=1)
    if topology == "async":
        kw.update(async_buffer=16)
    assert C.wire_ledger(**kw) == JC.wire_ledger(**kw)


_ENGINES = {  # name -> (JAX span name, configuration on top of BASE)
    "fused": ("fused_span", dict(defense="Krum")),
    "tele": ("tele_span", dict(defense="Krum", telemetry=True)),
    "fault": ("fault_span", dict(defense="Krum",
                                 faults=dict(dropout=0.1, straggler=0.1))),
    "traffic": ("traffic_span", dict(
        defense="Krum", traffic=dict(population=40, rate=0.7, seed=1))),
    "async": ("async_span", dict(defense="TrimmedMean",
                                 aggregation="async", async_buffer=12,
                                 staleness_weight="poly")),
    "hier": ("hier_span", dict(defense="Krum", users_count=20,
                               aggregation="hierarchical", megabatch=5,
                               tier2_defense="Median")),
    "hier_tele": ("hier_tele_span", dict(
        defense="Krum", users_count=20, aggregation="hierarchical",
        megabatch=5, tier2_defense="Krum", telemetry=True)),
    "vanilla": ("tele_span", dict(defense="NoDefense", secagg="vanilla")),
    "vanilla_dropped": ("fault_span", dict(
        defense="NoDefense", secagg="vanilla",
        faults=dict(dropout=0.2))),
    "groupwise": ("hier_tele_span", dict(
        defense="NoDefense", users_count=20, aggregation="hierarchical",
        megabatch=5, tier2_defense="Krum", secagg="groupwise")),
    "groupwise_dropped": ("fault_span", dict(
        defense="NoDefense", users_count=20, aggregation="hierarchical",
        megabatch=5, tier2_defense="Krum", secagg="groupwise",
        faults=dict(dropout=0.2))),
}


@pytest.mark.parametrize("name", sorted(_ENGINES))
def test_engine_span_name_and_wire_ledger_equal_jax(name, jax_pair_ds):
    want, kw = _ENGINES[name]
    jexp, texp = pair(jax_pair_ds, **kw)
    assert texp._span_entry_name() == jexp._span_entry_name() == want
    assert texp.wire_ledger() == jexp.wire_ledger()


def test_the_aten_model():
    a, b = torch.randn(6, 8), torch.randn(8, 5)
    with C.count_costs() as c:
        with C.stage_scope("deliver"):
            y = a @ b                         # 2 * 6 * 5 * 8 FLOPs
            v = y.view(-1)                    # a view: nothing
        with C.stage_scope("apply"):
            z = y + 1.0                       # one an element
        s = z.sum()                           # one a reduced element
    del v, s
    assert c.stages["deliver"] == {"flops": 480.0,
                                   "bytes_accessed": 4.0 * (48 + 40 + 30)}
    assert c.stages["apply"] == {"flops": 30.0,
                                 "bytes_accessed": 4.0 * (30 + 30)}
    assert c.unattributed == {"flops": 30.0, "bytes_accessed": 4.0 * 31}
    tot, att = c.totals(), c.attribution()
    for m in ("flops", "bytes_accessed"):
        assert tot[m] == math.fsum(
            [att["unattributed"][m]] + [v[m] for v in att["stages"].values()])
    assert att["coverage"]["flops"] == 510.0 / 540.0


def test_scopes_are_a_shared_no_op_unless_armed():
    assert C.stage_scope("deliver") is C.stage_scope("apply")
    with C.armed():
        scope = C.stage_scope("deliver")
        assert scope is not C.stage_scope("apply")
        with scope:
            assert C.current_stage() == "deliver"
    assert C.current_stage() is None
    with pytest.raises(AssertionError, match="unknown stage"):
        C.stage_scope("craft")


def _keys_ids(n, seed):
    ids = np.random.default_rng(seed).permutation(1000)[:n]
    return SA.round_tables(threefry.fold_in(threefry.key(seed), 1), ids,
                           "cpu")


def _calls(n, d):
    """(kernel name, call, its modeled count): each wrapper on the CPU."""
    g = torch.Generator().manual_seed(n * 7 + d)
    G = torch.randn(n, d, generator=g)
    Gb = G.bfloat16()
    mask = torch.ones(n, dtype=torch.bool)
    mask[1] = mask[n - 2] = False
    w = torch.rand(n, generator=g)
    e = int(mask.sum())
    keys, ids = _keys_ids(n, 3)
    deltas = SM.secagg_deltas(keys, ids, d)
    words = torch.randint(0, 2 ** 32, (4, 2), dtype=torch.int64)
    return [
        ("pairwise_distances", lambda: pairwise_distances(G),
         pairwise_distances_cost(n, d)),
        ("pairwise_distances[bf16]",
         lambda: pairwise_distances(Gb),
         pairwise_distances_cost(n, d, bf16=True)),
        ("krum_scores", lambda: DK.krum_scores(G, 2),
         DK.krum_scores_cost(n, d)),
        ("krum_scores[bf16]", lambda: DK.krum_scores(Gb, 2),
         DK.krum_scores_cost(n, d, bf16=True)),
        ("trimmed_mean", lambda: DK.trimmed_mean_of(G, n - 3),
         DK.trimmed_mean_cost(n, d)),
        ("median", lambda: DK.median_of(G), DK.median_cost(n, d)),
        ("masked_trimmed_mean",
         lambda: DK.masked_trimmed_mean(G, mask, 2),
         DK.masked_cost(n, d, e, False, 3)),
        ("masked_trimmed_mean", lambda: DK.masked_trimmed_mean(
            G, mask, 2, weights=w), DK.masked_cost(n, d, e, True, 3)),
        ("masked_median", lambda: DK.masked_median(G, mask),
         DK.masked_cost(n, d, e, False, 1)),
        ("masked_median", lambda: DK.masked_median(G, mask, w),
         DK.masked_cost(n, d, e, True, 1)),
        ("threefry_bits", lambda: TB.threefry_bits(words, d),
         TB.threefry_bits_cost(4, d)),
        ("secagg_deltas", lambda: SM.secagg_deltas(keys, ids, d),
         SM.secagg_deltas_cost(n, d)),
        ("secagg_residue", lambda: SM.secagg_residue(keys, ids, mask, d),
         SM.secagg_residue_cost(n, d, e)),
        ("secagg_unmask_sum", lambda: SM.secagg_unmask_sum(
            G, deltas, None, mask), SM.secagg_unmask_sum_cost(
                n, d, False, True)),
    ]


@pytest.mark.parametrize("index", range(14))
@pytest.mark.parametrize("n,d", [(9, 33), (16, 257)])
def test_a_wrapper_books_its_modeled_formula(index, n, d):
    name, call, cost = _calls(n, d)[index]
    assert name in _build.KERNELS
    with C.count_costs() as c:
        with C.stage_scope("tier1_aggregate"):
            call()
    assert c.kernels == {name: {
        "calls": 1, "flops": float(cost.flops),
        "bytes_accessed": float(cost.bytes), "unit": cost.unit,
        "stages": {"tier1_aggregate": 1}}}
    # The plain version ran inside, and counted nothing.
    assert c.stages["tier1_aggregate"] == {
        "flops": float(cost.flops), "bytes_accessed": float(cost.bytes)}
    assert c.unattributed == {"flops": 0.0, "bytes_accessed": 0.0}


def test_a_plain_version_alone_counts_its_own_operations():
    G = torch.randn(9, 33)
    with C.count_costs() as c:
        DK.median_of_plain(G)
    assert not c.kernels
    assert c.totals()["flops"] != DK.median_cost(9, 33).flops


def test_kernel_formulas_are_the_table_bounds():
    # PERF.md's kernel table at (n, d) = (100, 79,510): the Gram's
    # operations, the bytes each kernel moves once.
    n, d = 100, 79_510
    gram = n * (n - 1) * d + 2 * n * d
    assert pairwise_distances_cost(n, d) == (gram, 4 * (n * d + n * n),
                                             "fp32")
    assert pairwise_distances_cost(n, d, True) == (
        gram, 2 * n * d + 4 * n * n, "bf16")
    assert DK.krum_scores_cost(n, d) == (gram, 4 * n * d + 8 * n, "fp32")
    assert DK.trimmed_mean_cost(n, d)[:2] == (3 * n * d, 4 * (n * d + d))
    assert DK.median_cost(n, d)[:2] == (n * d, 4 * (n * d + d))
    assert DK.masked_cost(n, d, 87, False, 3)[:2] == (
        3 * 87 * d, 4 * (87 * d + d) + n)
    assert DK.masked_cost(n, d, 64, True, 1)[:2] == (
        64 * d, 4 * (64 * d + d) + n + 4 * 64)
    assert TB.threefry_bits_cost(10, d)[:2] == (80 * 10 * d,
                                               8 * 10 * d + 160)
    pairs = n * (n - 1) // 2
    assert SM.secagg_deltas_cost(n, d) == (
        pairs * d * SM.OPS_PER_WORD, 4 * n * d + 8 * pairs + 8 * n, "int32")
    assert SM.secagg_residue_cost(n, d, 90)[:2] == (
        90 * 10 * d * 80, 4 * d + 8 * pairs + 9 * n)
    assert SM.secagg_unmask_sum_cost(n, d, True, True)[:2] == (
        0, 12 * n * d + 4 * d + n)


_REPORTS = {  # name -> (entry points, configuration)
    "flat": (["fused_round", "fused_span", "compute_grads", "defense_Krum",
              "eval"], dict(defense="Krum")),
    "flat faulted": (["fused_round", "fault_span", "compute_grads",
                      "defense_TrimmedMean", "eval"],
                     dict(defense="TrimmedMean",
                          faults=FaultConfig(dropout=0.1, straggler=0.1,
                                             corrupt=0.05))),
    "flat secagg vanilla": (["fused_round", "fault_span", "compute_grads",
                             "defense_NoDefense", "eval"],
                            dict(defense="NoDefense", secagg="vanilla",
                                 faults=FaultConfig(dropout=0.1))),
    "flat backdoor": (["fused_round", "fused_span", "compute_grads",
                       "defense_Krum", "eval"],
                      dict(defense="Krum", backdoor="pattern",
                           mal_batch_size=16, mal_epochs=1)),
    "flat DnC": (["fused_round", "fused_span", "compute_grads",
                  "defense_DnC", "eval"], dict(defense="DnC")),
    "traffic": (["traffic_round", "traffic_span", "compute_grads",
                 "defense_Krum", "eval"],
                dict(defense="Krum", traffic=TrafficConfig(
                    population=32, rate=0.65, reliability_lo=0.3,
                    reliability_hi=0.6, churn_dwell=2, seed=1))),
    "async": (["async_round", "async_span", "compute_grads",
               "defense_TrimmedMean", "eval"],
              dict(defense="TrimmedMean", aggregation="async",
                   async_buffer=8, staleness_weight="poly",
                   faults=FaultConfig(dropout=0.1, corrupt=0.05))),
    "hier": (["hier_round", "hier_span", "compute_grads", "defense_Krum",
              "tier2_Median", "eval"],
             dict(defense="Krum", aggregation="hierarchical", megabatch=4,
                  tier2_defense="Median")),
    "hier secagg groupwise": (["hier_round", "hier_tele_span",
                               "compute_grads", "defense_NoDefense",
                               "tier2_Krum", "eval"],
                              dict(defense="NoDefense",
                                   aggregation="hierarchical", megabatch=4,
                                   tier2_defense="Krum", mal_prop=0.1,
                                   secagg="groupwise")),
}


def _run(cfg, ds, report):
    attacker = (make_attacker(cfg, ds, device="cpu") if cfg.backdoor
                else DriftAttack(1.5))
    exp = FederatedExperiment(cfg, attacker, ds, device="cpu")
    logger = RunLogger(cfg, log_dir=None, log=lambda s: None)
    ledger = exp.cost_report(logger) if report else None
    head = len(logger.events)
    exp.run(logger)
    return exp, ledger, logger.events[:head], logger.events[head:]


@pytest.mark.parametrize("name", sorted(_REPORTS))
def test_cost_report_events_and_a_byte_equal_run(name, small_ds):
    entries, kw = _REPORTS[name]
    cfg = ExperimentConfig(**{**SMALL, **kw})
    on, ledger, report, after = _run(cfg, small_ds, True)
    off, _, _, plain = _run(cfg, small_ds, False)
    assert [r.name for r in ledger.records] == entries
    assert not ledger.errors and not ledger.compiles
    for kind in ("cost", "stage_cost"):
        assert [e["name"] for e in report if e["kind"] == kind] == entries
    assert not [e for e in report if e["kind"] == "compile"]
    wire = [e for e in report if e["kind"] == "wire_bytes"]
    assert len(wire) == 1 and wire[0]["topology"] == cfg.aggregation
    for e in report:
        validate_event(e)
        jax_validate_event(e)
        if e["kind"] == "cost":
            assert e["peak_bytes"] == 0 and e["peak_measured"] is False
    for rec in ledger.records:
        att = rec.attribution
        for m in ("flops", "bytes_accessed"):
            assert math.isclose(math.fsum(
                [att["unattributed"][m]]
                + [v[m] for v in att["stages"].values()]),
                getattr(rec, m), rel_tol=1e-12)
    assert "tier1_aggregate" in ledger.records[0].attribution["stages"]
    # The run after the report is the run without it.
    assert torch.equal(on.state.weights.view(torch.int32),
                       off.state.weights.view(torch.int32))
    assert torch.equal(on.state.velocity.view(torch.int32),
                       off.state.velocity.view(torch.int32))

    def strip(evs):
        return json.dumps([{k: v for k, v in e.items() if k != "t"}
                           for e in evs], sort_keys=True)

    assert strip(after) == strip(plain)


def test_cost_record_payloads_are_jax_s():
    att = {"stages": {"deliver": {"flops": 10.0}},
           "unattributed": {"flops": 0.0}, "coverage": {"flops": 1.0}}
    kw = dict(name="fused_round", platform="cpu", flops=10.0,
              bytes_accessed=20.0, compile_s=0.123456, cache="miss",
              attribution=att)
    rec, jrec = C.CostRecord(**kw), JC.CostRecord(**kw)
    assert rec.compile_event() == jrec.compile_event()
    assert rec.stage_event() == jrec.stage_event()
    mine, theirs = rec.cost_event(), jrec.cost_event()
    for k in ("kind", "name", "flops", "bytes_accessed",
              "collective_bytes"):
        assert mine[k] == theirs[k], k
    # No allocator on the CPU: 0, said to be not measured.
    assert mine["peak_bytes"] == 0 and mine["peak_measured"] is False
    assert C.CostRecord(name="x", platform="cuda",
                        peak_allocated=123).cost_event()["peak_bytes"] == 123
    for ev in (rec.compile_event(), mine, rec.stage_event()):
        jax_validate_event(ev)
        validate_event(ev)


def test_compile_facts_of_the_libraries(tmp_path, monkeypatch):
    # A library already under _build/ is a hit (build_all, entry_point);
    # nvcc's builds are misses with build_all's seconds (on the card).
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "COMPILES", {})
    _build.library_path("median").write_bytes(b"")
    assert _build.build_all(["median"]) == {"median.cu": 0.0}
    _build._note_compile("krum_scores", 12.5, "miss")
    _build._note_compile("krum_scores[bf16]", 0.0, "hit")   # one library
    ledger = C.CompileLedger()
    ledger.add_compiles(_build.COMPILES)
    assert [r.compile_event() for r in ledger.compiles] == [
        {"kind": "compile", "name": "median", "compile_s": 0.0,
         "cache": "hit", "platform": "cuda"},
        {"kind": "compile", "name": "krum_scores", "compile_s": 12.5,
         "cache": "miss", "platform": "cuda"}]
