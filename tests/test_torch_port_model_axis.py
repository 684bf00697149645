"""The mesh's model axis (parallel/mesh.py, parallel/model_axis.py)
against the JAX package's sharded rounds and the port's own.

On the CPU the positions are ``"cpu"`` devices and the JAX package runs
on the 8 virtual CPU devices of tests/conftest.py:

- the plain versions of the four new entry points (``gram_partials``,
  its bf16 route, ``gram_epilogue``, ``krum_rows``) on split column
  blocks against the plain fused versions (rel 1e-5), identical rows
  exactly 0 apart; the epilogue's refusals (mixed devices, more model
  positions than its cap);
- the split route's stage-1 plan (``split_plan``): d covered exactly by
  non-empty slices of whole chains in clusters, a block's shared memory,
  one wave where the tiles fit, and its rounding chain from the order;
- the mesh: column blocks, their gather, the sum over the model axis
  (the epilogue's) in position order, the
  state placed as column blocks where m divides d and whole where not
  (JAX ``_model_axis_or_none``: d = 79,510 splits at m = 2, not at 4);
- the flat round at (4, 2), (2, 4) and (1, 2) within JAX's band (atol
  2e-5, rtol 1e-5) of the JAX engine's sharded round at the same shape
  (JAX's test_parallel.py configuration: n = 8, f = 2, batch 8, two
  rounds, Krum); the five reference defenses at (2, 2), faulted and
  not, against the port's unsharded round, selections equal or a
  near-tie adjudicated in fp64;
- the hierarchical round at (4, 2) and (2, 4) bit for bit the port's
  (c, 1) SPMD round, and within the hierarchy tests' band of the JAX
  engine's scan;
- a model-axis checkpoint has the unsharded layout and resumes bit for
  bit; the wire ledger prices the partials' and the state's gathers;
- the campaign cell with ``mesh_shape`` [2, 2] builds and runs.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from attacking_federate_learning_tpu import config as JC
from attacking_federate_learning_tpu.attacks import DriftAttack as JDrift
from attacking_federate_learning_tpu.config import (
    ExperimentConfig as JConfig
)
from attacking_federate_learning_tpu.core.engine import (
    FederatedExperiment as JExperiment
)
from attacking_federate_learning_tpu.data.datasets import (
    load_dataset as jax_load_dataset
)
from attacking_federate_learning_tpu.parallel.mesh import (
    make_plan as jax_make_plan
)
from attacking_federate_learning_tpu_torch import config as C
from attacking_federate_learning_tpu_torch.attacks import DriftAttack
from attacking_federate_learning_tpu_torch.campaigns.spec import (
    CampaignSpec
)
from attacking_federate_learning_tpu_torch.config import (
    ExperimentConfig, FaultConfig
)
from attacking_federate_learning_tpu_torch.core.engine import (
    FederatedExperiment
)
from attacking_federate_learning_tpu_torch.core.server import (
    ServerState, init_server_state
)
from attacking_federate_learning_tpu_torch.data.datasets import load_dataset
from attacking_federate_learning_tpu_torch.defenses import oracle
from attacking_federate_learning_tpu_torch.defenses.kernels import (
    DEFENSES, bulyan_select, distances_for, sort_scores
)
from attacking_federate_learning_tpu_torch.ops import defense_kernels as DK
from attacking_federate_learning_tpu_torch.ops import distances as DI
from attacking_federate_learning_tpu_torch.parallel import model_axis as MA
from attacking_federate_learning_tpu_torch.parallel.mesh import (
    PerPosition, make_plan
)
from attacking_federate_learning_tpu_torch.utils import checkpoint as CK
from attacking_federate_learning_tpu_torch.utils.numerics import adjudicate
from attacking_federate_learning_tpu_torch.utils.weights import (
    from_jax_params
)

SIZES = dict(synth_train=256, synth_test=64)
ROUNDS = 2
ATOL, RTOL = 2e-5, 1e-5            # JAX's test_parallel.py band
REL_L2 = 1e-6                      # the hierarchy tests' band
D_MLP = 79_510                     # mnist_mlp's d


def cpu_plan(c, m):
    return make_plan((c, m), ["cpu"] * (c * m))


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """The port on two intra-op threads (speed only: each comparison
    here is within one setting, bit for bit, or within a band)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def datasets():
    return (jax_load_dataset(JC.SYNTH_MNIST, seed=0, **SIZES),
            load_dataset(C.SYNTH_MNIST, seed=0, **SIZES))


# ---------------------------------------------------------------------------
# the four new entry points' plain versions

def _matrix(n, d, seed, dtype=torch.float32):
    G = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (n, d)).astype(np.float32)).to(dtype)
    G[3] = G[0]
    G[7] = G[0]                        # ALIE's identical crafted rows
    return G


@pytest.mark.parametrize("n,d,m", [(17, 300, 2), (40, 1_001, 4),
                                   (100, 2_184, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_split_stages_are_the_fused_plain_versions(n, d, m, dtype):
    G = _matrix(n, d, n + d, dtype)
    blocks = [b.contiguous() for b in torch.tensor_split(G, m, dim=1)]
    parts = [DI.gram_partials(b) for b in blocks]
    assert all(p.slices == 1 and p.ws.shape == (n, n) for p in parts)
    D = DI.gram_epilogue(parts)
    assert torch.equal(D, D.T) and not torch.diagonal(D).any()
    assert float(D[0, 3]) == float(D[3, 7]) == float(D[7, 0]) == 0.0
    # The fused plain version takes its norms from a sum of its own, so
    # its identical rows sit at cancellation noise apart (about
    # sqrt(eps) of the norm), not at 0: the comparison holds them to the
    # split's 0.
    want = DI.pairwise_distances_plain(G)
    same = torch.zeros_like(want, dtype=torch.bool)
    for i in (0, 3, 7):
        for j in (0, 3, 7):
            same[i, j] = True
    assert float(want[same].max()) < 1e-2 * float(want.max())
    want = torch.where(same, 0.0, want)
    torch.testing.assert_close(D, want, rtol=1e-5,
                               atol=1e-5 * float(want.max()))
    for f in (1, 4):
        comp = DK.krum_complement(n, f)
        scores, rowsums = DK.krum_rows(D, comp)
        ws, wr = DK.krum_rows_plain(want, comp)
        torch.testing.assert_close(scores, ws, rtol=1e-5,
                                   atol=1e-5 * float(wr.max()))
        torch.testing.assert_close(rowsums, wr, rtol=1e-5, atol=0)
    # krum_rows on the fused matrix is the fused Krum scores' plain
    # version bit for bit.
    for f in (1, 4):
        fused = DK.krum_scores_plain(G, f)
        got = DK.krum_rows(DI.pairwise_distances_plain(G),
                           DK.krum_complement(n, f))
        assert all(torch.equal(a, b) for a, b in zip(got, fused))


def test_the_epilogue_sums_in_position_order_from_the_summed_diagonal():
    G = _matrix(9, 64, 5)
    grams = [DI.gram_partials_plain(b) for b in torch.tensor_split(G, 4, 1)]
    S = grams[0] + grams[1] + grams[2] + grams[3]
    sq = torch.diagonal(S)
    want = torch.sqrt(torch.clamp(sq[:, None] + sq[None, :] - 2 * S, min=0))
    want.fill_diagonal_(0.0)
    assert torch.equal(DI.gram_epilogue_plain(grams), want)


def test_krum_rows_refuses_a_complement_out_of_range():
    with pytest.raises(ValueError, match="0 <= comp <= n - 1"):
        DK.krum_rows(torch.zeros(4, 4), 4)


def test_the_epilogue_refuses_mixed_devices():
    part = DI.GramPartials(torch.zeros(3, 3), 3, 1)
    with pytest.raises(ValueError, match="all be CUDA or all CPU"):
        DI.gram_epilogue([part], device="cuda")
    with pytest.raises(ValueError, match="all be CUDA or all CPU"):
        DI.gram_epilogue([part, part], device="cuda")


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_the_epilogue_refuses_m_above_its_cap(device):
    cap = DI.EPILOGUE_MAX_POSITIONS
    part = DI.GramPartials(torch.eye(3), 3, 1)
    assert DI.gram_epilogue([part] * cap).shape == (3, 3)
    with pytest.raises(ValueError, match=f"{cap + 1} model positions, "
                       f"above the epilogue's cap of "
                       f"EPILOGUE_MAX_POSITIONS = {cap}"):
        DI.gram_epilogue([part] * (cap + 1), device=device)


# ---------------------------------------------------------------------------
# the split route's stage-1 plan (csrc/gram_split.cuh)

SPLIT_SHAPES = [(100, 39_755), (100, 5_460), (1_000, 39_755)]


def _split_slices(plan):
    """Each slice's k range as csrc/gram_tile.cuh:split_slice deals the
    chains out."""
    T, S, c = -(-plan.d // plan.chain), plan.slices, plan.chain
    return [(s * T // S * c, min((s + 1) * T // S * c, plan.d))
            for s in range(S)]


@pytest.mark.parametrize("n,d", SPLIT_SHAPES)
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_split_plan_covers_d_fits_and_fills_the_card(n, d, bf16):
    sms = 132
    slots = DI.default_cluster_slots(sms)
    plan = DI.split_plan(n, d, sms, bf16)
    assert plan.tiles == -(-n // 128) * (-(-n // 128) + 1) // 2
    # d exactly, in S non-empty runs of whole chains, S a multiple of the
    # cluster.
    ranges = _split_slices(plan)
    assert ranges[0][0] == 0 and ranges[-1][1] == d
    assert all(a < b and a % plan.chain == 0 for a, b in ranges)
    assert all(x[1] == y[0] for x, y in zip(ranges, ranges[1:]))
    assert plan.cluster in DI.CLUSTERS and plan.slices % plan.cluster == 0
    assert plan.chains == -(-d // plan.chain)
    assert plan.cps == max(-(-(b - a) // plan.chain) for a, b in ranges)
    if bf16:
        base = DI.mma_plan(n, d, sms)
        assert plan.chain % plan.stage_k == 0 or base.groups > 1
        assert plan.stage_k <= base.stage_k
    else:
        assert plan.chain % 32 == 0
        assert plan.kgroups == DI.gram_plan(n, d, sms).kgroups
    assert plan.smem_bytes <= 232_448
    assert plan.mid_floats == (plan.tiles * plan.runs * 128 * 128
                               if plan.runs > 1 else 0)
    # No short last wave of clusters; where the tiles fit one wave, one
    # wave, and the card is filled as far as the chains allow: for every
    # cluster size and chain, the one-wave layout with the most slices is
    # estimated no faster (it may run fewer chains a block, but adds more
    # cluster sums to the tail).
    slot = slots[DI.CLUSTERS.index(plan.cluster)]
    clusters = plan.tiles * plan.runs
    waves = -(-clusters // slot)
    assert waves == 1 or clusters - (waves - 1) * slot >= slot / 2
    if plan.tiles == 1:
        assert waves == 1
        mine = DI.split_estimate(plan, sms, slots)
        for cluster, most in zip(DI.CLUSTERS, slots):
            for chain in (plan.chain, 256):
                total = -(-d // chain)
                slices = min(total, cluster * most)
                slices -= slices % cluster
                if slices < 1:
                    continue
                full = plan._replace(chain=chain, chains=total,
                                     cluster=cluster, slices=slices,
                                     cps=-(-total // slices))
                assert mine <= DI.split_estimate(full, sms, slots)


def test_split_plan_leaves_no_second_wave_and_no_idle_card():
    # The fused route's plan (gram_plan) at (100, 39,755): 156 blocks, a
    # second wave of 24 on 132 SMs; at mnist_cnn's (100, 5,460): 22.
    for slots in (None, (132, 66, 30, 15, 7)):
        plan = DI.split_plan(100, 39_755, 132, False, slots)
        assert plan.tiles * plan.slices <= 132
        assert plan.cps * plan.chain <= 2 * 256
        small = DI.split_plan(100, 5_460, 132, False, slots)
        assert small.tiles * small.slices > 22
        assert small.cps * small.chain < 256
    # A card that holds fewer clusters of 16 takes another plan.
    fewer = DI.split_plan(100, 39_755, 132, False, (132, 66, 33, 16, 7))
    slot = (132, 66, 33, 16, 7)[DI.CLUSTERS.index(fewer.cluster)]
    assert fewer.runs <= slot


@pytest.mark.parametrize("n,d", SPLIT_SHAPES + [(17, 300), (1, 1),
                                               (10, 8_972_340)])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_split_plan_rounding_chain_is_its_order(n, d, bf16):
    plan = DI.split_plan(n, d, 132, bf16)
    ranges = _split_slices(plan)
    cps = max(-(-(b - a) // plan.chain) for a, b in ranges)
    # A chain (the k groups' FMA chains then their sums in group order;
    # or the chain's wgmma k16 steps), the slice's chains in order, the
    # cluster's partials in rank order, the runs' sums in order.
    head = (plan.chain // 16 if bf16 else
            plan.chain // plan.kgroups + plan.kgroups - 1)
    want = head + (cps - 1) + (plan.cluster - 1) + (plan.slices
                                                    // plan.cluster - 1)
    assert plan.rounding_chain == want
    # Within the chain phase 3's band allows for kernel 1 on all of d.
    assert plan.rounding_chain <= 256 + -(-d // 256) + 16


def test_split_plan_refuses_empty_shapes():
    with pytest.raises(ValueError, match="split_plan needs"):
        DI.split_plan(0, 10, 132)


# ---------------------------------------------------------------------------
# the mesh's model axis

def test_column_blocks_gather_and_psum_in_position_order():
    plan = cpu_plan(2, 3)
    assert plan.clients_parts == 2 and plan.model_parts == 3
    x = torch.arange(22.0).reshape(2, 11)
    blocks = plan.split_cols(x)
    assert isinstance(blocks, PerPosition)
    assert [b.shape[1] for b in blocks] == [4, 4, 3]
    assert plan.col_bounds(11) == [(0, 4), (4, 8), (8, 11)]
    assert all(b.is_contiguous() and b.data_ptr() != x.data_ptr()
               for b in blocks)
    assert torch.equal(plan.all_gather_cols(blocks), x)
    # The sum over the model axis is the epilogue's, in position order:
    # (1e8 + 1) - 1e8 is 0 in f32, so both rows' summed norms and their
    # distance are 0; summed in another order the distance would be 1.
    vals = [torch.tensor([1e8, 1.0]), torch.tensor([1.0, 1e8]),
            torch.tensor([-1e8, -1e8])]
    parts = [DI.GramPartials(torch.diag(v), 2, 1) for v in vals]
    D = DI.gram_epilogue(parts)
    assert torch.equal(D, torch.zeros(2, 2))
    other = DI.gram_epilogue_plain([torch.diag(vals[i]) for i in (0, 2, 1)])
    assert float(other[0, 1]) == 1.0
    assert plan.primary == plan.positions[0] == plan.model_positions[0]


@pytest.mark.parametrize("m,splits", [(2, True), (4, False), (5, True)])
def test_d_splits_where_jax_shards_it(m, splits):
    plan = cpu_plan(1, m)
    jplan = jax_make_plan((1, m), jax.devices()[:m])
    assert plan.splits(D_MLP) == splits
    assert (jplan.weights_spec(D_MLP)[0] == "model") == splits
    w = torch.arange(float(D_MLP))
    st = plan.place_state(ServerState(w, -w, 3))
    assert isinstance(st.weights, PerPosition) == splits
    whole = plan.whole_state(st)
    assert torch.equal(whole.weights, w) and torch.equal(whole.velocity, -w)
    assert whole.round == 3


# ---------------------------------------------------------------------------
# the flat round

_FLAT = dict(dataset=C.SYNTH_MNIST, users_count=8, mal_prop=0.25,
             batch_size=8, epochs=ROUNDS, defense="Krum", **SIZES)


def _jax_flat(ds, shape):
    cfg = JConfig(**_FLAT)
    exp = JExperiment(cfg, attacker=JDrift(cfg.num_std), dataset=ds,
                      shardings=jax_make_plan(
                          shape, jax.devices()[:shape[0] * shape[1]]))
    params = jax.tree.map(np.asarray, exp.flat.unravel(exp.state.weights))
    for t in range(ROUNDS):
        exp.run_round(t)
    return from_jax_params(params), np.asarray(exp.state.weights)


def _flat_run(ds, plan, w0=None, rounds=ROUNDS, **kw):
    cfg = ExperimentConfig(**{**_FLAT, **kw})
    exp = FederatedExperiment(cfg, DriftAttack(cfg.num_std), ds,
                              device="cpu", shardings=plan)
    if w0 is not None:
        exp.state = init_server_state(w0.clone())
    for t in range(rounds):
        exp.run_round(t)
    return exp


@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (1, 2)])
def test_flat_round_is_within_jax_s_band_of_its_sharded_round(shape,
                                                            datasets):
    w0, w_jax = _jax_flat(datasets[0], shape)
    exp = _flat_run(datasets[1], cpu_plan(*shape), w0)
    split = shape[1] == 2                    # 79,510 % 4 != 0
    assert isinstance(exp._state.weights, PerPosition) == split
    assert (exp._model_agg is not None) == split
    np.testing.assert_allclose(exp.state.weights.numpy(), w_jax,
                               atol=ATOL, rtol=RTOL)


_FIVE = [("NoDefense", {}), ("Krum", {}), ("TrimmedMean", {}),
         ("Median", {}), ("Bulyan", dict(users_count=12, mal_prop=0.2))]


@pytest.mark.parametrize("faults", [False, True], ids=["clean", "faulted"])
@pytest.mark.parametrize("defense,kw", _FIVE, ids=[d for d, _ in _FIVE])
def test_five_defenses_at_2_2_match_the_unsharded_round(defense, kw, faults,
                                                        datasets):
    if faults:
        kw = dict(kw, faults=FaultConfig(dropout=0.2))
    ref = _flat_run(datasets[1], None, defense=defense, **kw)
    exp = _flat_run(datasets[1], cpu_plan(2, 2), defense=defense, **kw)
    assert exp._model_agg is not None
    np.testing.assert_allclose(exp.state.weights.numpy(),
                               ref.state.weights.numpy(), atol=ATOL,
                               rtol=RTOL)


def _selection(name, G, n, f, D):
    if name == "Krum":
        return [int(torch.argmin(sort_scores(D, n, f)))]
    return sorted(int(i) for i in bulyan_select(D, n, f))


@pytest.mark.parametrize("name", ["Krum", "Bulyan"])
@pytest.mark.parametrize("seed", range(4))
def test_split_selections_are_the_unsplit_ones_or_fp64_near_ties(name, seed):
    n, f, d = 23, 5, 640
    G = _matrix(n, d, seed)
    G[:f] = G[f:].mean(0) - 1.5 * G[f:].std(0)       # an ALIE cohort
    plan = cpu_plan(1, 4)
    D_split = MA.split_distances(plan, plan.split_cols(G))
    D_whole = distances_for(G)
    got = _selection(name, G, n, f, D_split)
    want = _selection(name, G, n, f, D_whole)
    agg = MA.split_defense(
        ExperimentConfig(defense=name), plan, d)(plan, G, n, f)
    whole = DEFENSES[name](G, n, f)
    if got == want:
        np.testing.assert_allclose(plan.all_gather_cols(agg).numpy(),
                                   whole.numpy(), atol=ATOL, rtol=RTOL)
        return
    # A decision the two roundings take apart must be a near-tie of the
    # fp64 distances.
    D64 = oracle.np_pairwise_distances(G.double().numpy())
    verdict = adjudicate(D_split.numpy(), D_whole.numpy(), D64)
    assert verdict["in_tie_band"], verdict


# ---------------------------------------------------------------------------
# the hierarchical round

def _hier_cfg(**kw):
    base = dict(dataset=C.SYNTH_MNIST, users_count=16, mal_prop=0.25,
                batch_size=8, epochs=ROUNDS, test_step=ROUNDS,
                aggregation="hierarchical", megabatch=4,
                defense="Median", tier2_defense="Krum", **SIZES)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def jax_scan(datasets):
    jexp = JExperiment(JConfig(**_hier_cfg(), aggregation_impl="xla"),
                       attacker=JDrift(1.0), dataset=datasets[0])
    params = jax.tree.map(np.asarray, jexp.flat.unravel(jexp.state.weights))
    for t in range(ROUNDS):
        jexp.run_round(t)
    return from_jax_params(params), np.asarray(jexp.state.weights)


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)])
def test_hier_round_is_its_c_1_spmd_round_bit_for_bit(shape, datasets,
                                                      jax_scan):
    w0, w_jax = jax_scan
    runs = []
    for plan in (cpu_plan(*shape), cpu_plan(shape[0], 1)):
        exp = FederatedExperiment(ExperimentConfig(**_hier_cfg()),
                                  DriftAttack(1.0), datasets[1],
                                  device="cpu", shardings=plan)
        exp.state = init_server_state(w0.clone())
        assert exp._hier_spmd
        for t in range(ROUNDS):
            exp.run_round(t)
        runs.append(exp)
    split, ref = runs
    assert isinstance(split._state.weights, PerPosition) == (shape[1] == 2)
    assert torch.equal(split.state.weights, ref.state.weights)
    assert torch.equal(split.state.velocity, ref.state.velocity)
    w = split.state.weights.numpy()
    assert np.linalg.norm(w - w_jax) / np.linalg.norm(w_jax) <= REL_L2


def test_the_cohort_guard_at_4_2_is_jax_s(datasets):
    """JAX's test_participation.py:125-130: a 10-client cohort of 20 that
    the clients axis of (4, 2) does not divide is refused at
    construction, with JAX's message."""
    kw = dict(dataset=C.SYNTH_MNIST, users_count=20, mal_prop=0.25,
              batch_size=16, epochs=4, defense="Krum", num_std=1.0,
              participation=0.5, distance_impl="ring", mesh_shape=(4, 2),
              **SIZES)
    with pytest.raises(ValueError, match="round cohort") as je:
        JExperiment(JConfig(**kw), attacker=JDrift(1.0),
                    dataset=datasets[0])
    with pytest.raises(ValueError) as te:
        FederatedExperiment(ExperimentConfig(**kw), DriftAttack(1.0),
                            datasets[1], device="cpu")
    assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# checkpoints, the wire ledger, the campaign cell

def test_a_model_axis_checkpoint_is_unsharded_and_resumes_bit_for_bit(
        datasets, tmp_path):
    whole = _flat_run(datasets[1], cpu_plan(1, 2), rounds=4)
    half = _flat_run(datasets[1], cpu_plan(1, 2), rounds=2)
    flat = _flat_run(datasets[1], None, rounds=2)
    paths = []
    for name, exp in (("split", half), ("flat", flat)):
        ck = CK.Checkpointer(exp.cfg, run_dir=str(tmp_path / name))
        paths.append(ck.save(exp.state, 0.5, tag="r2"))
    with np.load(paths[0]) as a, np.load(paths[1]) as b:
        assert sorted(a.files) == sorted(b.files)
        assert a["weights"].shape == b["weights"].shape == (D_MLP,)
        np.testing.assert_allclose(a["weights"], b["weights"], atol=ATOL,
                                   rtol=RTOL)
    resumed = _flat_run(datasets[1], cpu_plan(1, 2), rounds=0)
    resumed.state = CK.Checkpointer(half.cfg).resume(paths[0],
                                                     device="cpu")
    assert isinstance(resumed._state.weights, PerPosition)
    for t in range(2, 4):
        resumed.run_round(t)
    assert torch.equal(resumed.state.weights, whole.state.weights)
    assert torch.equal(resumed.state.velocity, whole.state.velocity)


@pytest.mark.parametrize("defense,grams", [("Krum", True),
                                           ("TrimmedMean", False)])
def test_the_wire_ledger_prices_the_model_axis(defense, grams, datasets):
    exp = _flat_run(datasets[1], cpu_plan(2, 2), rounds=0, defense=defense,
                    users_count=100, mal_prop=0.24)
    seams = exp.wire_ledger()["seams"]
    assert seams["model_state"]["bytes"] == D_MLP * 4
    # Each of the 2 model positions sends its block's (100, 100) f32 Gram.
    want = 2 * 4 * 100 * 100 if grams else 0
    assert seams["model_partials"]["bytes"] == want
    unsplit = _flat_run(datasets[1], None, rounds=0, defense=defense)
    assert "model_state" not in unsplit.wire_ledger()["seams"]


def test_a_campaign_cell_with_mesh_shape_2_2_builds_and_runs(tmp_path,
                                                            datasets):
    spec = CampaignSpec.from_json(json.dumps(dict(
        name="mesh", base=dict(dataset="SYNTH_MNIST", users_count=8,
                               mal_prop=0.25, batch_size=8, epochs=1,
                               log_dir=str(tmp_path / "logs"),
                               run_dir=str(tmp_path / "runs"), **SIZES),
        cells=[dict(mesh_shape=[2, 2], defense="TrimmedMean")])))
    cell = spec.expand()[-1]
    assert cell.skip is None and cell.cfg.mesh_shape == (2, 2)
    cfg = dataclasses.replace(cell.cfg, epochs=1)
    exp = FederatedExperiment(cfg, DriftAttack(cfg.num_std), datasets[1],
                              device="cpu", shardings=cpu_plan(2, 2))
    exp.run_round(0)
    ref = FederatedExperiment(dataclasses.replace(cfg, mesh_shape=None),
                              DriftAttack(cfg.num_std), datasets[1],
                              device="cpu")
    ref.run_round(0)
    np.testing.assert_allclose(exp.state.weights.numpy(),
                               ref.state.weights.numpy(), atol=ATOL,
                               rtol=RTOL)
