"""The SPMD client map and the mesh rounds of the port vs the JAX package.

On the CPU, the port's positions are ``"cpu"`` devices
(``make_plan((p, 1), ["cpu"] * p)``) and the JAX package runs on the 8
virtual CPU devices of tests/conftest.py:

- ``spmd_schedule`` equal to the JAX package's (grids, counts, select,
  padded shards, shard ids) over test_multichip_hier.py's grid, and its
  refusal of an S the clients axis does not divide, word for word;
- a hierarchical round over p positions bit for bit the port's
  sequential round, for every tier-2 defense in both placements
  ('concentrated' pads the schedule), with dropout faults and telemetry
  on (the telemetry and fault records equal too), and within the
  hierarchy tests' band (relative L2 1e-6) of the JAX engine's
  sequential scan (the JAX package's SPMD rounds fail on this jax);
- position ownership: while a position runs, every other position's
  replicas and the primary's state are NaN (indices out of range), and
  the rounds still match;
- the flat round under (c, 1) for c = 2, 4, 8 against the port's
  unsharded round and the JAX engine's ``make_plan((8, 1))`` round,
  within JAX's band (atol 2e-5, rtol 1e-5); 'ring' and 'allgather'
  under Krum and Bulyan pick what the distance kernel's route picks;
- the refusals a mesh makes reachable, with the JAX engine's messages;
  a campaign cell with such an S is skipped, not crashed; the wire
  ledger's gather seam equals the JAX engine's.
"""

import json
import math

import jax
import numpy as np
import pytest
import torch

from attacking_federate_learning_tpu import config as JC
from attacking_federate_learning_tpu.attacks import DriftAttack as JDrift
from attacking_federate_learning_tpu.campaigns.spec import (
    CampaignSpec as JSpec
)
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
from attacking_federate_learning_tpu.ops import federated as JFD
from attacking_federate_learning_tpu.parallel.mesh import (
    make_plan as jax_make_plan
)
from attacking_federate_learning_tpu_torch import config as C
from attacking_federate_learning_tpu_torch.attacks import DriftAttack
from attacking_federate_learning_tpu_torch.campaigns.spec import (
    CampaignSpec, cfg_to_cli_args
)
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
from attacking_federate_learning_tpu_torch.ops import federated as FD
from attacking_federate_learning_tpu_torch.parallel.mesh import make_plan
from attacking_federate_learning_tpu_torch.utils.weights import (
    from_jax_params
)

SIZES = dict(synth_train=256, synth_test=64)
ROUNDS = 2
REL_L2 = 1e-6                      # the hierarchy tests' band
ATOL, RTOL = 2e-5, 1e-5            # JAX's test_parallel.py band
# (tier 1, tier 2): every defense at each tier once.
PAIRS = [("Krum", "Bulyan"), ("Bulyan", "TrimmedMean"),
         ("TrimmedMean", "Median"), ("Median", "NoDefense"),
         ("NoDefense", "Krum")]


def cpu_plan(p):
    return make_plan((p, 1), ["cpu"] * p)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """The port on two intra-op threads, as in
    tests/test_torch_port_hierarchy.py (beside the other workers, every
    core a worker spins more than it computes); each comparison here is
    within one setting, or within a band against JAX."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def datasets():
    return (jax_load_dataset(JC.SYNTH_MNIST, seed=0, **SIZES),
            load_dataset(C.SYNTH_MNIST, seed=0, **SIZES))


# ---------------------------------------------------------------------------
# the schedule

@pytest.mark.parametrize("mal_placement", ["spread", "concentrated"])
@pytest.mark.parametrize("n,f,m,parts", [
    (32, 8, 4, 8), (32, 8, 4, 4), (64, 15, 4, 8), (48, 5, 4, 6),
])
def test_spmd_schedule_is_jax_s(n, f, m, parts, mal_placement):
    got = FD.spmd_schedule(FD.make_placement(n, f, m, mal_placement), parts)
    want = JFD.spmd_schedule(JFD.make_placement(n, f, m, mal_placement),
                             parts)
    assert len(got.grids) == len(want.grids)
    for a, b in zip(got.grids + got.sids, want.grids + want.sids):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got.counts == want.counts and got.parts == want.parts
    assert got.padded_shards == want.padded_shards
    assert got.select.dtype == want.select.dtype
    assert np.array_equal(got.select, want.select)


@pytest.mark.parametrize("parts", [8, 4, 0])
def test_spmd_schedule_refuses_with_jax_s_message(parts):
    with pytest.raises(ValueError) as je:
        JFD.spmd_schedule(JFD.make_placement(24, 5, 4, "spread"), parts)
    with pytest.raises(ValueError) as te:
        FD.spmd_schedule(FD.make_placement(24, 5, 4, "spread"), parts)
    assert str(te.value) == str(je.value)


def test_client_map_spmd_restores_megabatch_order_and_drops_padding():
    place = FD.make_placement(32, 8, 4, "concentrated")   # groups 2 and 6
    plan = cpu_plan(4)
    seen = []

    def fn(sid, ids, c, tag):
        seen.append((sid, tag))
        return {"est": torch.tensor([float(sid), float(ids[0]), float(c)]),
                "pos": tag.clone()}

    tags = FD.broadcast(torch.tensor(0), plan)
    for q in range(4):
        tags[q].fill_(q)
    buf = torch.empty(8, 3)
    out = FD.client_map(fn, place, tags, with_sid=True, out={"est": buf},
                        plan=plan)
    assert out["est"] is buf
    want = FD.client_map(lambda sid, ids, c: torch.tensor(
        [float(sid), float(ids[0]), float(c)]), place, with_sid=True)
    assert torch.equal(buf, want)
    sched = FD.spmd_schedule(place, 4)
    assert len(seen) == sched.padded_shards == 12     # 4 padding rows
    # Position q ran its own rows: every row it ran carries its tag.
    owner = {}
    for q, grid in enumerate(np.split(np.arange(sched.padded_shards), 4)):
        for r in grid:
            owner[r] = q
    assert [int(out["pos"][s]) for s in range(8)] == [
        owner[int(sched.select[s])] for s in range(8)]


# ---------------------------------------------------------------------------
# hierarchical rounds

def _hier_cfg(**kw):
    base = dict(dataset=C.SYNTH_MNIST, users_count=64, mal_prop=0.25,
                batch_size=8, epochs=ROUNDS, test_step=ROUNDS,
                aggregation="hierarchical", megabatch=8, **SIZES)
    base.update(kw)
    return base


def _pair_kw(tier1, tier2, placement):
    kw = dict(defense=tier1, tier2_defense=tier2, mal_placement=placement)
    if tier1 == "Bulyan":
        kw["tier1_corrupted"] = 1
    if tier2 == "Bulyan":
        kw["tier2_corrupted"] = 1
    return kw


def _port(ds, plan, faults=None, **kw):
    cfg = ExperimentConfig(**_hier_cfg(**kw),
                           faults=faults and FaultConfig(**faults))
    return FederatedExperiment(cfg, DriftAttack(1.0), ds, device="cpu",
                               shardings=plan)


def _same_tree(a, b):
    """Equal records: tensors bit for bit (NaN where the other has NaN,
    as some diagnostics are over dead rows), the rest ==."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        return all(_same_tree(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
        return True
    return a == b


@pytest.mark.parametrize("placement,p", [("spread", 8), ("concentrated", 4)])
@pytest.mark.parametrize("tier1,tier2", PAIRS,
                         ids=[f"{a}-{b}" for a, b in PAIRS])
def test_spmd_round_is_the_sequential_round_bit_for_bit(tier1, tier2,
                                                        placement, p,
                                                        datasets):
    kw = dict(_pair_kw(tier1, tier2, placement), telemetry=True,
              faults=dict(dropout=0.2, seed=3))
    seq, spmd = _port(datasets[1], None, **kw), _port(datasets[1],
                                                      cpu_plan(p), **kw)
    assert spmd._hier_spmd and not seq._hier_spmd
    spmd.state = init_server_state(seq.state.weights.clone())
    seq.run_round(0)
    spmd.run_round(0)
    assert torch.equal(spmd.state.weights, seq.state.weights)
    assert torch.equal(spmd.state.velocity, seq.state.velocity)
    assert torch.equal(spmd._estimates, seq._estimates)
    assert _same_tree(spmd.last_round_telemetry, seq.last_round_telemetry)
    assert _same_tree(spmd.last_round_faults, seq.last_round_faults)


def test_spmd_groupwise_secagg_round_is_the_sequential_round(datasets):
    """Groupwise secure aggregation under the map: each position masks
    its megabatches with its copies of the round's pair tables."""
    kw = dict(defense="NoDefense", tier2_defense="Median", secagg="groupwise",
              users_count=16, megabatch=4, faults=dict(dropout=0.2, seed=5))
    seq, spmd = _port(datasets[1], None, **kw), _port(datasets[1],
                                                      cpu_plan(2), **kw)
    spmd.state = init_server_state(seq.state.weights.clone())
    seq.run_round(0)
    spmd.run_round(0)
    assert torch.equal(spmd.state.weights, seq.state.weights)
    assert _same_tree(spmd.last_round_secagg, seq.last_round_secagg)
    assert int(seq.last_round_secagg["sum_check_ok"]) == 1


def test_spmd_nan_guard_raises_and_keeps_the_state(datasets):
    """The crafted-rows flag of each megabatch comes back through the
    gather: a NaN craft raises once, before the state is touched."""
    from attacking_federate_learning_tpu_torch.attacks import make_attacker

    cfg = ExperimentConfig(**_hier_cfg(defense="Median",
                                       tier2_defense="Median",
                                       backdoor="pattern", mal_batch_size=8,
                                       mal_placement="concentrated"))
    exp = FederatedExperiment(cfg, make_attacker(cfg, datasets[1],
                                                 device="cpu"),
                              datasets[1], device="cpu",
                              shardings=cpu_plan(4))
    assert exp._check_attack_nan and exp._hier_spmd
    exp.attacker.craft = lambda mal, ctx: torch.full(mal.shape[1:],
                                                     math.nan)
    w0 = exp.state.weights.clone()
    with pytest.raises(FloatingPointError,
                       match="Got nan in backdoor shadow training"):
        exp.run_round(0)
    assert torch.equal(exp.state.weights, w0) and exp.state.round == 0


def test_spmd_round_is_within_the_band_of_the_jax_scan(datasets):
    kw = _hier_cfg(defense="Krum", tier2_defense="Median",
                   mal_placement="concentrated")
    jexp = JExperiment(JConfig(**kw, aggregation_impl="xla"),
                       attacker=JDrift(1.0), dataset=datasets[0])
    texp = _port(datasets[1], cpu_plan(4), defense="Krum",
                 tier2_defense="Median", mal_placement="concentrated")
    params = jax.tree.map(np.asarray, jexp.flat.unravel(jexp.state.weights))
    texp.state = init_server_state(from_jax_params(params))
    for t in range(ROUNDS):
        jexp.run_round(t)
        texp.run_round(t)
    w = np.asarray(jexp.state.weights)
    rel = np.linalg.norm(texp.state.weights.numpy() - w) / np.linalg.norm(w)
    assert rel <= REL_L2, rel


# ---------------------------------------------------------------------------
# ownership: a position reads its own replicas only

class _Poison:
    """While one position runs, every other position's tensors (and the
    primary's server state) hold NaN, or an out-of-range index; restored
    after."""

    def __init__(self, exp):
        self.exp = exp
        self.rounds = []        # the per-position values each round made
        inner = exp.shardings.broadcast

        def broadcast(value):
            out = inner(value)
            if out is not None:
                self.rounds.append(out)
            return out

        exp.shardings.broadcast = broadcast

    def others(self, q):
        reps = self.exp._reps
        for r, rep in enumerate(reps):
            if r != q:
                yield from (v for v in (rep.shards, rep.train_x,
                                        rep.train_y, rep.grid)
                            if v is not None)
                yield from rep.style or ()
        for per in self.rounds:
            for r, v in enumerate(per):
                if r != q and isinstance(v, torch.Tensor):
                    yield v
        yield self.exp.state.weights
        yield self.exp.state.velocity

    def run(self, q, fn):
        saved = []
        for v in self.others(q):
            saved.append((v, v.clone()))
            if v.is_floating_point():
                v.fill_(math.nan)
            elif v.dtype == torch.bool:
                v.fill_(True)
            else:
                v.fill_(10 ** 9)
        try:
            return fn()
        finally:
            for v, old in saved:
                v.copy_(old)


def _position_of(per_position, value):
    return next(q for q, v in enumerate(per_position) if v is value)


def test_each_hierarchical_position_reads_only_its_own(datasets,
                                                       monkeypatch):
    kw = dict(_pair_kw("Median", "Krum", "concentrated"),
              faults=dict(dropout=0.2, seed=3))
    seq, spmd = _port(datasets[1], None, **kw), _port(datasets[1],
                                                      cpu_plan(4), **kw)
    spmd.state = init_server_state(seq.state.weights.clone())
    poison = _Poison(spmd)
    envs, client_map, run_rows = [], FD.client_map, FD._run_rows

    def mapped(shard_fn, place, *args, **kw):
        if kw.get("plan") is not None:       # the SPMD round's envs
            envs.append(args[0])
        return client_map(shard_fn, place, *args, **kw)

    def position_rows(shard_fn, heads, args, out):
        if not envs or args[0] not in envs[-1]:   # the sequential twin's
            return run_rows(shard_fn, heads, args, out)
        q = _position_of(envs[-1], args[0])
        return poison.run(q, lambda: run_rows(shard_fn, heads, args, out))

    monkeypatch.setattr(FD, "client_map", mapped)
    monkeypatch.setattr(FD, "_run_rows", position_rows)
    for t in range(ROUNDS):
        poison.rounds.clear()
        seq.run_round(t)
        spmd.run_round(t)
        assert torch.equal(spmd.state.weights, seq.state.weights), t
        assert bool(torch.isfinite(spmd.state.weights).all())


def test_each_flat_position_reads_only_its_own(datasets):
    base = dict(dataset=C.SYNTH_MNIST, users_count=8, mal_prop=0.25,
                batch_size=8, epochs=ROUNDS, defense="Krum",
                participation=0.5, **SIZES)
    ref = FederatedExperiment(ExperimentConfig(**base), DriftAttack(1.0),
                              datasets[1], device="cpu")
    exp = FederatedExperiment(ExperimentConfig(**base), DriftAttack(1.0),
                              datasets[1], device="cpu",
                              shardings=cpu_plan(2))
    exp.state = init_server_state(ref.state.weights.clone())
    poison = _Poison(exp)
    inner = exp._deliver_rows

    def deliver_rows(t, q, *a):
        return poison.run(q, lambda: inner(t, q, *a))

    exp._deliver_rows = deliver_rows
    for t in range(ROUNDS):
        poison.rounds.clear()
        ref.run_round(t)
        exp.run_round(t)
        assert torch.equal(exp.state.weights, ref.state.weights), t


# ---------------------------------------------------------------------------
# the flat round under (c, 1)

_FLAT = dict(dataset=C.SYNTH_MNIST, users_count=8, mal_prop=0.25,
             batch_size=8, epochs=ROUNDS, defense="Krum", **SIZES)


@pytest.fixture(scope="module")
def jax_flat(datasets):
    """The JAX engine's sharded flat round over its 8 devices (JAX's
    test_parallel.py configuration) and its initial weights."""
    cfg = JConfig(**_FLAT)
    exp = JExperiment(cfg, attacker=JDrift(cfg.num_std), dataset=datasets[0],
                      shardings=jax_make_plan((8, 1)))
    params = jax.tree.map(np.asarray, exp.flat.unravel(exp.state.weights))
    for t in range(ROUNDS):
        exp.run_round(t)
    return from_jax_params(params), np.asarray(exp.state.weights)


def _flat_run(ds, plan, w0, **kw):
    cfg = ExperimentConfig(**{**_FLAT, **kw})
    exp = FederatedExperiment(cfg, DriftAttack(cfg.num_std), ds,
                              device="cpu", shardings=plan)
    exp.state = init_server_state(w0.clone())
    picks = []
    for t in range(ROUNDS):
        exp.run_round(t)
        if cfg.telemetry:
            picks.append(exp.last_round_telemetry[
                "defense_selection_mask"].clone())
    return exp, picks


@pytest.mark.parametrize("c", [2, 4, 8])
def test_flat_mesh_round_matches_unsharded_and_jax_s(c, datasets, jax_flat):
    w0, w_jax = jax_flat
    single, _ = _flat_run(datasets[1], None, w0)
    exp, _ = _flat_run(datasets[1], cpu_plan(c), w0)
    assert exp.shardings.clients_parts == c and not exp._hier_spmd
    np.testing.assert_allclose(exp.state.weights.numpy(),
                               single.state.weights.numpy(),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(exp.state.weights.numpy(), w_jax,
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("impl", ["ring", "allgather"])
@pytest.mark.parametrize("defense", ["Krum", "Bulyan"])
def test_blockwise_distances_pick_what_the_kernel_route_picks(
        defense, impl, datasets):
    kw = dict(defense=defense, telemetry=True)
    if defense == "Bulyan":
        kw.update(users_count=16, mal_prop=0.125)
    w0 = FederatedExperiment(ExperimentConfig(**{**_FLAT, **kw}),
                             DriftAttack(1.0), datasets[1],
                             device="cpu").state.weights
    ref, ref_picks = _flat_run(datasets[1], None, w0, **kw)
    exp, picks = _flat_run(datasets[1], cpu_plan(4), w0,
                           distance_impl=impl, **kw)
    for a, b in zip(picks, ref_picks):
        assert torch.equal(a, b)
    np.testing.assert_allclose(exp.state.weights.numpy(),
                               ref.state.weights.numpy(), atol=ATOL,
                               rtol=RTOL)


# ---------------------------------------------------------------------------
# refusals, the campaign pre-check and the wire ledger

_REFUSALS = {
    "straggler-spmd": dict(aggregation="hierarchical", megabatch=4,
                           defense="TrimmedMean",
                           faults=dict(straggler=0.1)),
    "traffic-spmd": dict(aggregation="hierarchical", megabatch=4,
                         defense="Median", traffic=dict(population=256)),
    "ring-hier": dict(aggregation="hierarchical", megabatch=4,
                      defense="Krum", distance_impl="ring"),
    "indivisible-S": dict(aggregation="hierarchical", megabatch=4,
                          users_count=24, defense="Median"),
    "ring-cohort": dict(defense="Krum", distance_impl="ring",
                        users_count=12),
}


@pytest.mark.parametrize("name", list(_REFUSALS))
def test_the_mesh_s_refusals_are_jax_s(name, datasets):
    kw = dict(_REFUSALS[name])
    faults, traffic = kw.pop("faults", None), kw.pop("traffic", None)
    base = dict(dataset=C.SYNTH_MNIST, users_count=32, mal_prop=0.25,
                batch_size=8, epochs=1, mesh_shape=(8, 1), **SIZES)
    base.update(kw)
    with pytest.raises(ValueError) as je:
        JExperiment(JConfig(**base,
                            faults=faults and JFaultConfig(**faults),
                            traffic=traffic and JTrafficConfig(**traffic)),
                    attacker=JDrift(1.0), dataset=datasets[0])
    with pytest.raises(ValueError) as te:
        FederatedExperiment(
            ExperimentConfig(**base, faults=faults and FaultConfig(**faults),
                             traffic=traffic and TrafficConfig(**traffic)),
            DriftAttack(1.0), datasets[1], device="cpu",
            shardings=cpu_plan(8))
    assert str(te.value) == str(je.value)


def test_a_cell_with_an_indivisible_s_is_skipped_not_crashed(tmp_path):
    blob = dict(name="mesh", base=dict(
        dataset=C.SYNTH_MNIST, users_count=24, mal_prop=0.25, batch_size=8,
        epochs=1, aggregation="hierarchical", megabatch=4,
        defense="Median", log_dir=str(tmp_path / "logs"),
        run_dir=str(tmp_path / "runs"), **SIZES),
        axes={"mesh_shape": [[8, 1], [2, 1]]})
    got = CampaignSpec.from_json(json.dumps(blob)).expand()
    want = JSpec.from_json(json.dumps(blob)).expand()
    assert [c.skip for c in got] == [c.skip for c in want]
    assert "clients axis=8" in got[0].skip and got[1].skip is None
    assert got[1].cfg.mesh_shape == (2, 1)
    assert got[1].row()["mesh_shape"] == [2, 1]
    args = cfg_to_cli_args(got[1].cfg)
    assert args[args.index("--mesh-shape") + 1] == "2,1"


def test_the_wire_ledger_prices_the_gather_as_jax_s(datasets):
    kw = dict(defense="Median", users_count=32, megabatch=4)
    texp = _port(datasets[1], cpu_plan(8), **kw)
    jexp = JExperiment(JConfig(**_hier_cfg(**kw), mesh_shape=(8, 1)),
                       attacker=JDrift(1.0), dataset=datasets[0])
    assert jexp._hier_spmd and texp._hier_spmd
    assert texp.wire_ledger() == jexp.wire_ledger()


# ---------------------------------------------------------------------------
# host streaming and the per-client transforms over the mesh (the JAX
# package's sharded tests/test_stream.py tests)

def _stream_run(ds, placement, plan, rounds=3, **kw):
    base = dict(dataset=C.SYNTH_MNIST, users_count=16, mal_prop=0.25,
                batch_size=16, epochs=rounds, defense="TrimmedMean",
                num_std=1.0, data_placement=placement, **SIZES)
    base.update(kw)
    exp = FederatedExperiment(ExperimentConfig(**base), DriftAttack(1.0), ds,
                              device="cpu", shardings=plan)
    for t in range(rounds):
        exp.run_round(t)
    return exp.state.weights


def test_streamed_sharded_equals_device(datasets):
    """Each position's rows of the streamed batch land on it: the run is
    byte-equal to the device-placed run over the same mesh (the JAX
    package holds its pair within atol 2e-6)."""
    got = _stream_run(datasets[1], "host_stream", cpu_plan(8), rounds=2)
    assert torch.equal(got, _stream_run(datasets[1], "device", cpu_plan(8),
                                        rounds=2))


@pytest.mark.parametrize("kw", [dict(partition="femnist_style"),
                                dict(partition="femnist_style",
                                     participation=0.5),
                                dict(data_augment=True)],
                         ids=["style", "style-cohort", "augment"])
def test_per_client_transforms_sharded_equal_unsharded(kw, datasets):
    """The style rows and the augmentation draws a position applies are
    its rows' of the unsharded batch (the JAX package's band, atol 2e-6,
    rtol 1e-6)."""
    got = _stream_run(datasets[1], "device", cpu_plan(4), **kw)
    want = _stream_run(datasets[1], "device", None, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6,
                               rtol=1e-6)
