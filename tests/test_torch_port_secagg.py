"""Secure aggregation in the port (``protocols/secagg.py``,
``ops/secagg_masks.py``) vs the JAX package's ``protocols/secagg.py``.

On the CPU, where the mask kernels take their plain versions:

- ``pair_keys``, ``pairwise_deltas``, ``mask_rows`` / ``unmask_rows`` /
  ``modular_sum``, ``recovery_residue`` and ``unmask_sum`` (the recovered
  rows, the sum check and the four stats) bit for bit the JAX package's,
  at n = 3, 19, 32 and d = 257, 4,099 with non-contiguous ids, alive
  masks all-true, one-dead, one-alive and random, on matrices spanning
  16 decades with NaN and Inf rows;
- a numpy model of the deltas kernel's loop (its split of the pairs over
  blocks, its row tiles) equal to the plain version for several plans,
  and the plan's limits;
- vanilla NoDefense ALIE rounds, clean and with dropout 0.25, against
  the JAX engine within the flat round tests' band (atol 1e-5), their
  'secagg' events equal to JAX's; groupwise rounds' events against the
  JAX engine's (counts exact, the group sums' norms within rel 1e-6);
  every event passes JAX's ``validate_event``, and ``secagg_summary``
  reads the same from both;
- every masked port run bit-equal to its clear twin: vanilla clean and
  faulted, groupwise under tier-2 NoDefense, Krum and Median, clean and
  with shard-domain dropout;
- a preempted and resumed run bit for bit the whole one, its events
  written once a round;
- the config's refusals, the non-fusable attacker's and the CLI flag
  equal to JAX's; the kernel wrappers raise for CUDA tensors without a
  kernel and refuse what their kernels do not take.
"""

import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attacking_federate_learning_tpu import cli as jax_cli
from attacking_federate_learning_tpu import config as JC
from attacking_federate_learning_tpu.attacks import DriftAttack as JDrift
from attacking_federate_learning_tpu.config import (
    ExperimentConfig as JConfig, FaultConfig as JFaultConfig
)
from attacking_federate_learning_tpu.core.engine import (
    FederatedExperiment as JExperiment
)
from attacking_federate_learning_tpu.data.datasets import (
    load_dataset as jax_load_dataset
)
from attacking_federate_learning_tpu.protocols import secagg as jsa
from attacking_federate_learning_tpu.report import secagg_summary
from attacking_federate_learning_tpu.utils.metrics import (
    RunLogger as JRunLogger, validate_event as jax_validate_event
)
from attacking_federate_learning_tpu_torch import cli
from attacking_federate_learning_tpu_torch import config as C
from attacking_federate_learning_tpu_torch.attacks import DriftAttack
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
from attacking_federate_learning_tpu_torch.ops import _build
from attacking_federate_learning_tpu_torch.ops import secagg_masks as K
from attacking_federate_learning_tpu_torch.ops.threefry_bits import (
    threefry_bits_plain
)
from attacking_federate_learning_tpu_torch.protocols import secagg as sa
from attacking_federate_learning_tpu_torch.utils import threefry
from attacking_federate_learning_tpu_torch.utils.checkpoint import (
    Checkpointer
)
from attacking_federate_learning_tpu_torch.utils.lifecycle import (
    GracefulShutdown, Preempted, RunJournal
)
from attacking_federate_learning_tpu_torch.utils.metrics import RunLogger
from attacking_federate_learning_tpu_torch.utils.weights import (
    from_jax_params
)

SIZES = dict(synth_train=256, synth_test=64)
NORM_REL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's many mid-sized int64 ops:
    beside other test workers on a shared machine, each op's OpenMP
    barrier waits on every thread being scheduled, which made this file
    five times slower with eight threads than with one (the results do
    not depend on it: every comparison here is bit for bit within one
    setting, or within a band against JAX)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _matrix(n, d, seed):
    """The JAX package's test matrix: magnitudes over 16 decades, with a
    NaN/Inf/denormal row in front."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, d)) * 10.0 ** rng.integers(-8, 8, (n, d))
    G = G.astype(np.float32)
    G[0, :6] = [np.nan, np.inf, -np.inf, -0.0, 1e-44, -2.5e38]
    return G


def _ids(n, seed):
    """Non-contiguous global ids, not sorted."""
    return np.random.default_rng(seed).permutation(10_000)[:n]


def _keys(seed, t):
    return (jax.random.fold_in(jax.random.key(seed), t),
            threefry.fold_in(threefry.key(seed), t))


def _bits(x):
    return np.asarray(x).view(np.uint32)


@functools.lru_cache(maxsize=None)
def _jax_deltas(seed, t, n, d):
    """JAX's masks for the ids _ids(n, n * d), shared by the cases of one
    shape."""
    jk, _ = _keys(seed, t)
    return jsa.pairwise_deltas(jk, jnp.asarray(_ids(n, n * d), jnp.int32),
                               d)


def _alive(kind, n, seed):
    if kind == "all":
        return np.ones(n, bool)
    if kind == "one-dead":
        a = np.ones(n, bool)
        a[n // 2] = False
        return a
    if kind == "one-alive":
        a = np.zeros(n, bool)
        a[n - 1] = True
        return a
    a = np.random.default_rng(seed).random(n) > 0.3
    a[:2] = [False, True]
    return a


# ---------------------------------------------------------------------------
# the protocol functions, bit for bit

def test_secagg_key_and_modes_are_jax_s():
    for seed in (0, 3, 2 ** 31 + 5):
        cfg = ExperimentConfig(seed=seed)
        want = jax.random.key_data(jsa.secagg_key(JConfig(seed=seed)))
        np.testing.assert_array_equal(sa.secagg_key(cfg), np.asarray(want))
    assert sa.SECAGG_MODES == jsa.SECAGG_MODES


@pytest.mark.parametrize("n", [3, 19, 32])
def test_pair_keys_are_jax_s_pair_keys(n):
    jk, tk = _keys(7, 3)
    ids = _ids(n, n)
    got = threefry.pair_keys(tk, ids)
    a, b = np.triu_indices(n, k=1)
    pair = jax.vmap(lambda x, y: jax.random.key_data(
        jsa._pair_key(jk, x, y)))
    want = np.asarray(pair(jnp.asarray(ids[a], jnp.int32),
                           jnp.asarray(ids[b], jnp.int32)))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint32
    # A batch of id rows gives each row's table.
    both = threefry.pair_keys(tk, np.stack([ids, ids[::-1]]))
    np.testing.assert_array_equal(both[0], got)
    np.testing.assert_array_equal(
        both[1], threefry.pair_keys(tk, ids[::-1]))
    with pytest.raises(OverflowError):
        threefry.pair_keys(tk, np.array([1, -2]))


@pytest.mark.parametrize("n,d", [(3, 257), (19, 257), (32, 4099)])
def test_pairwise_deltas_and_wire_are_jax_s(n, d):
    jk, tk = _keys(11, n)
    ids = _ids(n, d)
    want = np.asarray(jsa.pairwise_deltas(jk, jnp.asarray(ids, jnp.int32),
                                          d))
    got = sa.pairwise_deltas(tk, ids, d)
    assert got.dtype == torch.int32 and got.shape == (n, d)
    np.testing.assert_array_equal(_bits(got.numpy()), want)
    # Antisymmetric: the column sums vanish mod 2**32.
    assert not sa.modular_sum(got).any()
    G = _matrix(n, d, n + d)
    jwire = jsa.mask_rows(jnp.asarray(G), jnp.asarray(want))
    wire = sa.mask_rows(torch.from_numpy(G), got)
    np.testing.assert_array_equal(_bits(wire.numpy()), np.asarray(jwire))
    alive = _alive("random", n, d)
    for al in (None, alive):
        jal = None if al is None else jnp.asarray(al)
        tal = None if al is None else torch.from_numpy(al)
        back = sa.unmask_rows(wire, got, tal)
        jback = jsa.unmask_rows(jwire, jnp.asarray(want), jal)
        np.testing.assert_array_equal(_bits(back.numpy()), _bits(jback))
        np.testing.assert_array_equal(
            _bits(sa.modular_sum(wire, tal).numpy()),
            np.asarray(jsa.modular_sum(jwire, jal)))
    # Every bit pattern rides the wire, NaN and Inf included.
    np.testing.assert_array_equal(
        _bits(sa.unmask_rows(wire, got).numpy()), _bits(G))


_ALIVE = ["all", "one-dead", "one-alive", "random"]


@pytest.mark.parametrize("kind", _ALIVE)
@pytest.mark.parametrize("n,d", [(3, 257), (19, 4099), (32, 257)])
def test_residue_and_unmask_sum_are_jax_s(n, d, kind):
    jk, tk = _keys(5, n + d)
    ids = _ids(n, n * d)
    jids = jnp.asarray(ids, jnp.int32)
    alive = _alive(kind, n, n)
    G = _matrix(n, d, d)
    jd = _jax_deltas(5, n + d, n, d)
    jwire = jsa.mask_rows(jnp.asarray(G), jd)
    res, pairs = sa.recovery_residue(tk, ids, torch.from_numpy(alive), d)
    jres, jpairs = jsa.recovery_residue(jk, jids, jnp.asarray(alive), d)
    np.testing.assert_array_equal(_bits(res.numpy()), np.asarray(jres))
    assert int(pairs) == int(jpairs) == int(alive.sum() * (~alive).sum())
    tables = sa.round_tables(tk, ids, "cpu")
    deltas = K.secagg_deltas(*tables, d)
    for al in (None, alive):
        rec, stats = sa.unmask_sum(
            torch.from_numpy(G), deltas,
            None if al is None else torch.from_numpy(al), tables)
        jrec, jstats = jsa.unmask_sum(
            jwire, jd, jnp.asarray(G), None if al is None
            else jnp.asarray(al), jk, jids)
        np.testing.assert_array_equal(_bits(rec.numpy()), _bits(jrec))
        assert {k: int(v) for k, v in stats.items()} == {
            k: int(v) for k, v in jstats.items()}
        assert int(stats["secagg_sum_check_ok"]) == 1


@pytest.mark.parametrize("kind", [None, "random"])
def test_secagg_group_is_jax_s(kind):
    """One megabatch's round on its global ids: ``(recovered, ok)``
    without a dropout mask, ``(recovered, stats)`` with one."""
    n, d, t = 8, 300, 4
    ids = _ids(n, 3)
    G = _matrix(n, d, 5)
    alive = None if kind is None else _alive(kind, n, 2)
    rec, out = sa.secagg_group(torch.from_numpy(G), threefry.key(9), t,
                               ids, None if alive is None
                               else torch.from_numpy(alive))
    jrec, jout = jsa.secagg_group(jnp.asarray(G), jax.random.key(9), t,
                                  jnp.asarray(ids, jnp.int32),
                                  None if alive is None
                                  else jnp.asarray(alive))
    np.testing.assert_array_equal(_bits(rec.numpy()), _bits(jrec))
    if alive is None:
        assert int(out) == int(jout) == 1
    else:
        assert {k: int(v) for k, v in out.items()} == {
            k: int(v) for k, v in jout.items()}


def test_sum_check_fails_on_a_wrong_mask():
    """The check is real: one flipped word of one alive row's mask, or a
    residue left out while a row is dead, fails it."""
    n, d = 7, 300
    _, tk = _keys(2, 9)
    tables = sa.round_tables(tk, np.arange(n), "cpu")
    deltas = K.secagg_deltas(*tables, d)
    G = torch.from_numpy(_matrix(n, d, 1))
    assert int(K.secagg_unmask_sum(G, deltas)[1]) == 1
    bad = deltas.clone()
    bad[3, 17] ^= 1
    assert int(K.secagg_unmask_sum(G, bad)[1]) == 0
    alive = torch.ones(n, dtype=torch.bool)
    alive[2] = False
    res, _ = K.secagg_residue(*tables, alive, d)
    assert int(K.secagg_unmask_sum(G, deltas, res, alive)[1]) == 1
    assert int(K.secagg_unmask_sum(G, deltas, None, alive)[1]) == 0
    # ok is ANDed into, never set back to 1.
    ok = torch.zeros((), dtype=torch.int32)
    assert int(K.secagg_unmask_sum(G, deltas, ok=ok)[1]) == 0


# ---------------------------------------------------------------------------
# the deltas kernel's plan and loop

def _kernel_model(keys, ids, d, plan):
    """csrc/secagg_masks.cu's deltas kernel in numpy, block by block:
    each (column tile, row tile, pair split) walks its pairs from the
    decoded first one, keeps row a's sum apart until its run ends, and
    adds its partial sums into the output (uint32, wrapping)."""
    n, tile = len(ids), K.TILE_COLS
    P = n * (n - 1) // 2
    per = -(-P // plan.splits)
    words = threefry_bits_plain(K.from_words(keys), d).numpy().astype(
        np.uint32)
    out = np.zeros((n, d), np.uint32)
    for x in range(-(-d // tile)):
        cols = slice(x * tile, min(d, (x + 1) * tile))
        for y in range(-(-n // plan.row_tile)):
            r0 = y * plan.row_tile
            rows = min(n - r0, plan.row_tile)
            for z in range(plan.splits):
                p0, p1 = z * per, min(P, z * per + per)
                acc = np.zeros((rows, cols.stop - cols.start), np.uint32)
                if p0 < p1:
                    a, first = 0, 0
                    while first + (n - 1 - a) <= p0:
                        first += n - 1 - a
                        a += 1
                    b = a + 1 + (p0 - first)
                    own = np.zeros_like(acc[0])
                    for p in range(p0, p1):
                        a_in = r0 <= a < r0 + rows
                        b_in = r0 <= b < r0 + rows
                        if a_in or b_in:
                            m = words[p, cols]
                            ma = m if ids[a] < ids[b] else np.uint32(0) - m
                            own += ma
                            if b_in:
                                acc[b - r0] -= ma
                        b += 1
                        if b == n:
                            if a_in:
                                acc[a - r0] += own
                            own[:] = 0
                            a += 1
                            b = a + 1
                    if r0 <= a < min(n, r0 + rows):
                        acc[a - r0] += own
                out[r0:r0 + rows, cols] += acc
    return out


@pytest.mark.parametrize("n,d,row_tile,splits", [
    (2, 5, 2, 1), (7, 300, 7, 1), (7, 300, 7, 4), (19, 257, 5, 3),
    (12, 513, 12, 66), (13, 40, 4, 7)])
def test_the_kernel_loop_equals_the_plain_version(n, d, row_tile, splits):
    _, tk = _keys(4, n * d)
    ids = _ids(n, n)
    keys, tids = sa.round_tables(tk, ids, "cpu")
    plan = K.DeltasPlan(row_tile, splits, 4 * row_tile * K.TILE_COLS)
    want = K.secagg_deltas_plain(keys, tids, d).numpy().view(np.uint32)
    np.testing.assert_array_equal(_kernel_model(keys, ids, d, plan), want)


def test_deltas_plan():
    p = K.deltas_plan(100, 79_510)
    # One row tile of 100 KB, two blocks an SM, the pairs in 4 splits.
    assert p == K.DeltasPlan(100, 4, 102_400)
    for n, d in ((2, 5), (3, 257), (227, 79_510), (228, 4099),
                 (1000, 79_510), (10_000, 16)):
        p = K.deltas_plan(n, d)
        assert 1 <= p.row_tile <= min(n, 227) and p.splits >= 1
        assert p.smem == 4 * p.row_tile * K.TILE_COLS <= K.SMEM_BLOCK
        assert p.splits <= max(1, n * (n - 1) // 2 // 64)
    assert K.deltas_plan(228, 4099).row_tile == 227


# ---------------------------------------------------------------------------
# the wrappers' rules for CUDA tensors

class _Cuda:
    device = torch.device("cuda", 0)

    def __init__(self, dtype, shape, contiguous=True):
        self.dtype, self.shape, self._c = dtype, shape, contiguous

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return self._c

    def data_ptr(self):
        return 0


def _calls(n=4, d=8):
    keys = _Cuda(torch.int32, (n * (n - 1) // 2, 2))
    ids = _Cuda(torch.int64, (n,))
    alive = _Cuda(torch.bool, (n,))
    G = _Cuda(torch.float32, (n, d))
    deltas = _Cuda(torch.int32, (n, d))
    return {
        "secagg_deltas": lambda **kw: K.secagg_deltas(
            kw.get("keys", keys), kw.get("ids", ids), d,
            plan=K.DeltasPlan(n, 1, 4 * n * K.TILE_COLS)),
        "secagg_residue": lambda **kw: K.secagg_residue(
            kw.get("keys", keys), kw.get("ids", ids),
            kw.get("alive", alive), d,
            count=_Cuda(torch.int32, ())),
        "secagg_unmask_sum": lambda **kw: K.secagg_unmask_sum(
            kw.get("G", G), kw.get("deltas", deltas), None,
            kw.get("alive", alive), _Cuda(torch.int32, ())),
    }


@pytest.mark.parametrize("name", ["secagg_deltas", "secagg_residue",
                                  "secagg_unmask_sum"])
def test_mask_wrappers_raise_for_cuda_without_a_kernel(name, tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setenv("NVCC", str(tmp_path / "no-nvcc"))
    before = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="no nvcc found"):
        _calls()[name]()
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("name,kw,match", [
    ("secagg_deltas", dict(keys=_Cuda(torch.int64, (6, 2))), "int32"),
    ("secagg_deltas", dict(keys=_Cuda(torch.int32, (5, 2))), r"\(6, 2\)"),
    ("secagg_deltas", dict(ids=_Cuda(torch.int32, (4,))), "int64"),
    ("secagg_residue", dict(alive=_Cuda(torch.int32, (4,))), "bool"),
    ("secagg_residue", dict(alive=_Cuda(torch.bool, (3,))), r"\(4,\)"),
    ("secagg_unmask_sum", dict(deltas=_Cuda(torch.float32, (4, 8))),
     "int32"),
    ("secagg_unmask_sum", dict(G=_Cuda(torch.float32, (4, 8), False)),
     "contiguous 2-D float32"),
    ("secagg_unmask_sum", dict(alive=torch.ones(4, dtype=torch.bool)),
     "CUDA tensors"),
])
def test_mask_wrappers_refuse_what_their_kernels_do_not_take(name, kw,
                                                             match):
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        _calls()[name](**kw)
    assert _build.LAUNCHES == before


# ---------------------------------------------------------------------------
# whole runs

@pytest.fixture(scope="module")
def datasets():
    return (jax_load_dataset(JC.SYNTH_MNIST, seed=0, **SIZES),
            load_dataset(C.SYNTH_MNIST, seed=0, **SIZES))


def _base(tmp_path=None, **kw):
    base = dict(dataset=C.SYNTH_MNIST, users_count=12, mal_prop=0.25,
                batch_size=16, epochs=3, test_step=3, defense="NoDefense",
                **SIZES)
    if tmp_path is not None:
        base.update(log_dir=str(tmp_path / "logs"),
                    run_dir=str(tmp_path / "runs"))
    base.update(kw)
    return base


def _port(datasets, faults=None, **kw):
    cfg = ExperimentConfig(**_base(**kw),
                           faults=faults and FaultConfig(**faults))
    return FederatedExperiment(cfg, DriftAttack(1.0), datasets[1],
                               device="cpu")


def _strip(events, kind):
    return [{k: v for k, v in e.items() if k not in ("kind", "v", "t")}
            for e in events if e["kind"] == kind]


def _run_both(datasets, tmp_path, faults=None, **kw):
    """Both engines' ``run()`` from the JAX init, with their events."""
    base = _base(tmp_path, **kw)
    jcfg = JConfig(**base, faults=faults and JFaultConfig(**faults))
    jexp = JExperiment(jcfg, attacker=JDrift(1.0), dataset=datasets[0])
    tcfg = ExperimentConfig(**base, faults=faults and FaultConfig(**faults))
    texp = FederatedExperiment(tcfg, DriftAttack(1.0), datasets[1],
                               device="cpu")
    params = jax.tree.map(np.asarray, jexp.flat.unravel(jexp.state.weights))
    texp.state = init_server_state(from_jax_params(params))
    with JRunLogger(jcfg, None, jcfg.log_dir, jsonl_name="jax") as jl:
        jexp.run(jl)
    with RunLogger(tcfg, None, tcfg.log_dir, jsonl_name="port") as tl:
        out = texp.run(tl)
    events = []
    for path in (jl.jsonl_path, tl.jsonl_path):
        with open(path) as f:
            events.append([json.loads(line) for line in f])
    return jexp, texp, out, events


def _norms_close(got, want):
    for g, w in zip(got, want):
        assert len(g["group_sum_norms"]) == len(w["group_sum_norms"])
        for x, y in zip(g["group_sum_norms"], w["group_sum_norms"]):
            assert abs(x - y) <= NORM_REL * abs(y), (g["round"], x, y)


@pytest.mark.parametrize("faults", [None, dict(dropout=0.25)],
                         ids=["clean", "dropout"])
def test_vanilla_rounds_match_the_jax_engine(faults, datasets, tmp_path):
    jexp, texp, out, (jev, tev) = _run_both(datasets, tmp_path, faults,
                                            secagg="vanilla", users_count=8)
    np.testing.assert_allclose(texp.state.weights.numpy(),
                               np.asarray(jexp.state.weights), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(texp.state.velocity.numpy(),
                               np.asarray(jexp.state.velocity), atol=1e-5)
    for e in tev:
        jax_validate_event(e)
    got, want = _strip(tev, "secagg"), _strip(jev, "secagg")
    assert got == want == out["secagg"] and len(got) == 3
    assert all(e["sum_check_ok"] == 1 for e in got)
    assert _strip(tev, "fault") == _strip(jev, "fault")
    if faults:
        assert sum(e["recovery"] for e in got) >= 1
        for e, f in zip(got, _strip(tev, "fault")):
            drop = f["injected_dropout"]
            assert e["dropped"] == drop
            assert e["masks_reconstructed"] == (8 - drop) * drop
    assert secagg_summary(tev) == secagg_summary(jev)


@pytest.mark.parametrize("faults", [
    None, dict(dropout=0.2, shard_dropout=0.3, shard_dropout_dwell=2)],
    ids=["clean", "dropout"])
def test_groupwise_events_match_the_jax_engine(faults, datasets, tmp_path):
    jexp, texp, out, (jev, tev) = _run_both(
        datasets, tmp_path, faults, secagg="groupwise",
        aggregation="hierarchical", megabatch=4, tier2_defense="Krum")
    w, tw = np.asarray(jexp.state.weights), texp.state.weights.numpy()
    assert np.linalg.norm(tw - w) <= 1e-6 * np.linalg.norm(w)
    for e in tev:
        jax_validate_event(e)
    got, want = _strip(tev, "secagg"), _strip(jev, "secagg")
    assert len(got) == len(want) == 3
    assert out["secagg"] == got
    counts = [{k: v for k, v in e.items() if k != "group_sum_norms"}
              for e in got]
    assert counts == [{k: v for k, v in e.items() if k != "group_sum_norms"}
                      for e in want]
    assert all(e["groups"] == 3 and e["sum_check_ok"] == 1 for e in got)
    _norms_close(got, want)
    assert _strip(tev, "fault") == _strip(jev, "fault")
    if faults:
        assert any(e["recovery"] for e in got)
    s, js = secagg_summary(tev), secagg_summary(jev)
    np.testing.assert_allclose(s.pop("group_sum_norms_last"),
                               js.pop("group_sum_norms_last"), atol=1e-3)
    assert s == js


def _final(exp):
    return exp.state.weights.clone(), exp.state.velocity.clone()


@pytest.mark.parametrize("faults", [None, dict(dropout=0.25)],
                         ids=["clean", "dropout"])
def test_vanilla_runs_are_bit_equal_to_the_clear_runs(faults, datasets):
    runs = []
    for mode in ("off", "vanilla"):
        exp = _port(datasets, faults, secagg=mode, users_count=8)
        exp.run(log=lambda s: None)
        runs.append(_final(exp))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("faults", [
    None, dict(dropout=0.2, shard_dropout=0.3, shard_dropout_dwell=2)],
    ids=["clean", "shard-dropout"])
@pytest.mark.parametrize("tier2", ["NoDefense", "Krum", "Median"])
def test_groupwise_runs_are_bit_equal_to_the_clear_runs(tier2, faults,
                                                       datasets):
    runs = []
    for mode in ("off", "groupwise"):
        exp = _port(datasets, faults, secagg=mode,
                    aggregation="hierarchical", megabatch=4,
                    tier2_defense=tier2)
        out = exp.run(log=lambda s: None)
        runs.append(_final(exp))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert len(out["secagg"]) == 3
    if faults:
        assert {f["injected_dropout"] for f in out["faults"]} != {0}
        for e, f in zip(out["secagg"], out["faults"]):
            assert e["dropped"] == f["injected_dropout"]
            assert e["recovery"] == int(e["dropped"] > 0)


def test_groupwise_launches_per_group(datasets, monkeypatch):
    """Each megabatch draws its masks once, re-derives its dead members'
    residue once (in a group with no dropped member too, as the JAX
    package's ``unmask_sum`` does under an alive mask) and unmasks once,
    keyed on the group's global ids."""
    exp = _port(datasets, dict(dropout=0.2), secagg="groupwise", epochs=1,
                aggregation="hierarchical", megabatch=4,
                tier2_defense="NoDefense")
    seen = {"deltas": [], "residue": []}
    inner_d, inner_r = K.secagg_deltas, K.secagg_residue

    def deltas(keys, ids, d, plan=None):
        seen["deltas"].append(ids.tolist())
        return inner_d(keys, ids, d)

    def residue(keys, ids, alive, d, count=None):
        seen["residue"].append(ids.tolist())
        return inner_r(keys, ids, alive, d, count)

    from attacking_federate_learning_tpu_torch.core import faults as F

    def drops(t):
        masks, _, _ = F.hier_round_faults(exp._fault_key, t,
                                          exp._placement, exp.faults)
        return masks[:, 0].sum(1)

    # The first round with a group that dropped a member and one that
    # did not.
    t = next(t for t in range(50) if 0 in drops(t) and drops(t).any())
    k = drops(t)
    monkeypatch.setattr(K, "secagg_deltas", deltas)
    monkeypatch.setattr(K, "secagg_residue", residue)
    exp.run_round(t)
    grid = exp._placement.grid.tolist()
    assert seen["deltas"] == seen["residue"] == grid
    (_, _, rec), = exp._host_records([(None, None, exp.last_round_secagg)])
    assert rec["masks_reconstructed"] == int(((4 - k) * k).sum())
    assert rec["dropped"] == int(k.sum()) and rec["sum_check_ok"] == 1


def test_a_quarantined_row_in_a_round_without_a_drop_is_reconstructed(
        datasets, tmp_path):
    """An attacker's NaN rows are quarantined in faulted rounds whose
    schedule dropped no client: the protocol treats them as dropped, and
    the 'secagg' events (reconstructed pairs, sum check) equal the JAX
    engine's."""
    base = _base(tmp_path, secagg="vanilla", users_count=8)
    faults = dict(dropout=0.05)
    jcfg = JConfig(**base, faults=JFaultConfig(**faults))
    jexp = JExperiment(jcfg, attacker=JDrift(float("nan")),
                       dataset=datasets[0])
    tcfg = ExperimentConfig(**base, faults=FaultConfig(**faults))
    texp = FederatedExperiment(tcfg, DriftAttack(float("nan")), datasets[1],
                               device="cpu")
    params = jax.tree.map(np.asarray, jexp.flat.unravel(jexp.state.weights))
    texp.state = init_server_state(from_jax_params(params))
    with JRunLogger(jcfg, None, jcfg.log_dir, jsonl_name="jax") as jl:
        jexp.run(jl)
    with RunLogger(tcfg, None, tcfg.log_dir, jsonl_name="port") as tl:
        out = texp.run(tl)
    events = []
    for path in (jl.jsonl_path, tl.jsonl_path):
        with open(path) as f:
            events.append([json.loads(line) for line in f])
    jev, tev = events
    got, want = _strip(tev, "secagg"), _strip(jev, "secagg")
    assert got == want == out["secagg"] and len(got) == 3
    clean = [e for e, f in zip(got, _strip(tev, "fault"))
             if f["injected_dropout"] == 0]
    assert clean, "no round without a scheduled drop"
    f = texp.f
    for e in clean:
        assert e == {"round": e["round"], "sum_check_ok": 1, "dropped": f,
                     "masks_reconstructed": (8 - f) * f, "recovery": 1}
    assert torch.isfinite(texp.state.weights).all()
    np.testing.assert_allclose(texp.state.weights.numpy(),
                               np.asarray(jexp.state.weights), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("label", ["vanilla", "groupwise"])
def test_preempt_and_resume_is_bit_for_bit(label, datasets, tmp_path):
    kw = dict(secagg="vanilla", users_count=8) if label == "vanilla" else (
        dict(secagg="groupwise", aggregation="hierarchical", megabatch=4,
             tier2_defense="Krum"))
    faults = (dict(dropout=0.25) if label == "vanilla" else
              dict(dropout=0.2, shard_dropout=0.3, shard_dropout_dwell=2))

    cfg = ExperimentConfig(
        **_base(tmp_path, epochs=6, test_step=3, checkpoint_every=2, **kw),
        faults=FaultConfig(**faults))
    full = FederatedExperiment(cfg, DriftAttack(1.0), datasets[1],
                               device="cpu")
    whole = full.run(log=lambda s: None)
    ck = Checkpointer(cfg)
    exp = FederatedExperiment(cfg, DriftAttack(1.0), datasets[1],
                              device="cpu")
    with RunLogger(cfg, None, cfg.log_dir, jsonl_name="sa") as logger:
        with pytest.raises(Preempted):
            exp.run(logger, checkpointer=ck,
                    journal=RunJournal(cfg.run_dir, "sa"),
                    shutdown=GracefulShutdown(preempt_at_round=2))
    resumed = FederatedExperiment(cfg, DriftAttack(1.0), datasets[1],
                                  device="cpu")
    state, extra = ck.resume(ck.latest(), with_extra=True, device="cpu")
    assert 0 < int(state.round) < cfg.epochs
    resumed.state = state
    resumed.restore_carry_state(extra)
    with RunLogger(cfg, None, cfg.log_dir, jsonl_name="sa") as logger:
        resumed.run(logger, checkpointer=ck,
                    journal=RunJournal(cfg.run_dir, "sa"),
                    shutdown=GracefulShutdown(preempt_at_round=2))
    assert torch.equal(resumed.state.weights, full.state.weights)
    assert torch.equal(resumed.state.velocity, full.state.velocity)
    assert RunJournal(cfg.run_dir, "sa").verify(epochs=6, test_step=3) == []
    with open(logger.jsonl_path) as f:
        events = _strip([json.loads(line) for line in f], "secagg")
    assert [e["round"] for e in events] == list(range(6))
    assert events == whole["secagg"]


# ---------------------------------------------------------------------------
# messages and flags

_CONFIG_REJECTS = [
    dict(secagg="vanilla", defense="Krum"),
    dict(secagg="vanilla", defense="Bulyan"),
    dict(secagg="groupwise", aggregation="hierarchical", megabatch=4,
         defense="TrimmedMean"),
    dict(secagg="vanilla", aggregation="hierarchical", megabatch=4),
    dict(secagg="groupwise"),
    dict(secagg="vanilla", backdoor="pattern", backdoor_fused=False),
    dict(secagg="vanilla", participation=0.5),
    dict(secagg="vanilla", grad_dtype="bfloat16"),
    dict(secagg="vanilla", faults=dict(straggler=0.2)),
    dict(secagg="vanilla", faults=dict(corrupt=0.2)),
    dict(secagg="sideways"),
]


@pytest.mark.parametrize("kw", _CONFIG_REJECTS)
def test_config_refusals_are_jax_s(kw):
    kw = dict(kw)
    fc = kw.pop("faults", None)
    base = _base(**kw)
    with pytest.raises(ValueError) as je:
        JConfig(**base, faults=fc and JFaultConfig(**fc))
    with pytest.raises(ValueError) as te:
        ExperimentConfig(**base, faults=fc and FaultConfig(**fc))
    assert str(te.value) == str(je.value)


def test_the_non_fusable_attacker_is_refused_with_jax_s_message(datasets):
    class JStaged(JDrift):
        fusable = False

    class Staged(DriftAttack):
        fusable = False

    base = _base(secagg="vanilla")
    with pytest.raises(ValueError) as je:
        JExperiment(JConfig(**base), attacker=JStaged(1.0),
                    dataset=datasets[0])
    with pytest.raises(ValueError) as te:
        FederatedExperiment(ExperimentConfig(**base), Staged(1.0),
                            datasets[1], device="cpu")
    assert str(te.value) == str(je.value)


def test_cli_secagg_flag_is_jax_s():
    def action(parser):
        a, = [a for a in parser._actions if a.dest == "secagg"]
        return (a.option_strings, a.default, a.choices, a.help, a.type,
                a.metavar)

    assert action(cli.build_parser()) == action(jax_cli.build_parser())
    args = cli.build_parser().parse_args(
        ["-d", "NoDefense", "-s", "SYNTH_MNIST", "-n", "12", "--secagg",
         "groupwise", "--aggregation", "hierarchical", "--megabatch", "4",
         "--tier2-defense", "Krum"])
    cfg = cli.config_from_args(args)
    assert (cfg.secagg, cfg.aggregation, cfg.megabatch,
            cfg.tier2_defense) == ("groupwise", "hierarchical", 4, "Krum")
    assert cli.config_from_args(cli.build_parser().parse_args(
        ["-d", "NoDefense", "--secagg", "vanilla"])).secagg == "vanilla"


def test_cli_secagg_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["-s", C.SYNTH_MNIST, "-n", "8", "-e", "1", "-d",
                  "NoDefense", "--secagg", "vanilla", "--synth-train",
                  "100", "--synth-test", "20"])


def test_cli_runs_groupwise_on_the_cpu(tmp_path):
    out = cli.main(["-s", C.SYNTH_MNIST, "-d", "NoDefense", "-n", "8",
                    "-m", "0.25", "-e", "2", "-c", "16", "--aggregation",
                    "hierarchical", "--megabatch", "4", "--tier2-defense",
                    "Median", "--secagg", "groupwise", "--synth-train",
                    "200", "--synth-test", "40", "--log-dir",
                    str(tmp_path / "l"), "--run-dir", str(tmp_path / "r"),
                    "--device", "cpu"])
    assert [e["sum_check_ok"] for e in out["secagg"]] == [1, 1]
    assert all(math.isfinite(a) for a in out["accuracies"])
