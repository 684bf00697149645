"""The port's fault model vs the JAX package's core/faults.py.

- utils/threefry.py must be bit for bit ``jax.random`` (threefry2x32,
  partitionable): ``key``, ``fold_in``, ``split`` and ``uniform`` over a
  grid of seeds (the fault key's ``seed ^ 0x0FA7175`` and a
  ``FaultConfig.seed`` override among them), rounds and sizes.
- ``fault_masks``, ``apply_faults`` (the straggler ring across ``delay``
  rounds, each corruption mode) and ``quarantine`` must equal the JAX
  functions on the same inputs.
- Config and CLI errors are the JAX package's, word for word.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attacking_federate_learning_tpu import cli as jax_cli
from attacking_federate_learning_tpu.config import (
    ExperimentConfig as JConfig, FaultConfig as JFaultConfig
)
from attacking_federate_learning_tpu.core import faults as JF
from attacking_federate_learning_tpu_torch import cli
from attacking_federate_learning_tpu_torch import config as C
from attacking_federate_learning_tpu_torch.config import (
    ExperimentConfig, FaultConfig
)
from attacking_federate_learning_tpu_torch.core import faults as F
from attacking_federate_learning_tpu_torch.core.engine import (
    FederatedExperiment
)
from attacking_federate_learning_tpu_torch.utils import threefry

SEEDS = [0, 0 ^ 0x0FA7175, 42 ^ 0x0FA7175, 7, 2 ** 31 + 3, 123456789,
         2 ** 40 + 5]
ROUNDS = [0, 1, 2, 17, 299, 2 ** 31, 2 ** 32 - 1]


def _jax_key_data(k):
    return np.asarray(jax.random.key_data(k))


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_key_fold_in_split_match_jax(seed):
    k, jkey = threefry.key(seed), jax.random.key(seed)
    np.testing.assert_array_equal(k, _jax_key_data(jkey))
    for t in ROUNDS:
        kt, jkt = threefry.fold_in(k, t), jax.random.fold_in(jkey, t)
        np.testing.assert_array_equal(kt, _jax_key_data(jkt))
        for num in (1, 2, 3, 5):
            np.testing.assert_array_equal(
                threefry.split(kt, num),
                _jax_key_data(jax.random.split(jkt, num)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("m", [1, 7, 19, 100, 1000])
def test_threefry_uniform_matches_jax_bit_for_bit(seed, m):
    for t in ROUNDS[:5]:
        for k, jk in zip(threefry.split(threefry.fold_in(threefry.key(seed),
                                                         t), 3),
                         jax.random.split(jax.random.fold_in(
                             jax.random.key(seed), t), 3)):
            got = threefry.uniform(k, (m,))
            want = np.asarray(jax.random.uniform(jk, (m,)))
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))


def test_fold_in_refuses_what_uint32_cannot_hold():
    with pytest.raises(OverflowError):
        threefry.fold_in(threefry.key(0), -1)
    with pytest.raises(OverflowError):
        jax.random.fold_in(jax.random.key(0), -1)


_CONFIGS = [dict(dropout=0.3, straggler=0.2, corrupt=0.3),
            dict(dropout=0.15, straggler=0.15, straggler_delay=1,
                 corrupt=0.1),
            dict(dropout=0.1, straggler=0.1, straggler_delay=2,
                 corrupt=0.05),
            dict(straggler=0.9, straggler_delay=3),
            dict(corrupt=0.5, seed=42)]


@pytest.mark.parametrize("kw", _CONFIGS, ids=[str(i) for i in range(5)])
@pytest.mark.parametrize("m,m_mal", [(19, 4), (100, 10), (16, 0)])
def test_fault_masks_equal_the_jax_schedule(kw, m, m_mal):
    tcfg = ExperimentConfig(faults=FaultConfig(**kw), dataset=C.SYNTH_MNIST)
    jcfg = JConfig(faults=JFaultConfig(**kw), dataset=C.SYNTH_MNIST)
    key, jkey = F.fault_key(tcfg), JF.fault_key(jcfg)
    np.testing.assert_array_equal(key, _jax_key_data(jkey))
    for t in range(25):
        got = F.fault_masks(key, t, m, m_mal, tcfg.faults)
        want = JF.fault_masks(jkey, t, m, m_mal, jcfg.faults)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))
        drop, stale, corrupt = got
        assert not corrupt[:m_mal].any()          # honest rows only
        assert not (drop & stale).any() and not (drop & corrupt).any()
        if t < tcfg.faults.straggler_delay:
            assert not stale.any()                # cold ring buffer


@pytest.mark.parametrize("mode", ["nan", "inf", "scale"])
@pytest.mark.parametrize("delay", [1, 2, 3])
def test_apply_faults_and_quarantine_equal_jax(mode, delay):
    """Six rounds through the ring buffer: the faulted matrix, the dropout
    mask, the ring and the counts equal the JAX functions'; quarantine's
    clean matrix, mask and count too."""
    kw = dict(dropout=0.2, straggler=0.3, straggler_delay=delay,
              corrupt=0.3, corrupt_mode=mode, corrupt_scale=1e3)
    fc, jfc = FaultConfig(**kw), JFaultConfig(**kw)
    key = F.fault_key(ExperimentConfig(faults=fc))
    jkey = JF.fault_key(JConfig(faults=jfc))
    m, d, m_mal = 12, 7, 3
    state = F.init_fault_state(fc, m, d, "cpu")
    jstate = JF.init_fault_state(jfc, m, d)
    rng = np.random.default_rng(delay)
    for t in range(6):
        G = rng.standard_normal((m, d)).astype(np.float32)
        got, dropped, state, stats = F.apply_faults(
            torch.from_numpy(G), t, key, state, fc, m_mal)
        want, jdropped, jstate, jstats = JF.apply_faults(
            jnp.asarray(G), t, jkey, jstate, jfc, m_mal)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(dropped.numpy(), np.asarray(jdropped))
        np.testing.assert_array_equal(state["stale"].numpy(),
                                      np.asarray(jstate["stale"]))
        assert stats == {k[len("fault_"):]: int(v)
                         for k, v in jstats.items()}
        clean, mask, q = F.quarantine(got, dropped)
        jclean, jmask, jq = JF.quarantine(want, jdropped)
        np.testing.assert_array_equal(clean.numpy(), np.asarray(jclean))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        assert int(q["quarantined"]) == int(jq["fault_quarantined"])
        assert np.isfinite(clean.numpy()).all()


def test_without_stragglers_there_is_no_ring():
    fc = FaultConfig(dropout=0.5)
    assert F.init_fault_state(fc, 4, 3, "cpu") == {}
    G = torch.ones(4, 3)
    out, dropped, state, stats = F.apply_faults(
        G, 0, F.fault_key(ExperimentConfig(faults=fc)), {}, fc, 0)
    assert state == {} and stats["injected_straggler"] == 0
    assert torch.equal(out[dropped], torch.zeros_like(out[dropped]))


def test_quarantine_masks_nonfinite_and_dropped():
    G = torch.ones(5, 4)
    G[1], G[3] = torch.nan, torch.inf
    dropped = torch.tensor([False, False, True, False, False])
    clean, mask, stats = F.quarantine(G, dropped)
    assert mask.tolist() == [True, False, False, False, True]
    assert bool(torch.isfinite(clean).all())
    assert int(stats["quarantined"]) == 3


# ---------------------------------------------------------------------------
# config and CLI errors, word for word

_BAD_FAULTS = [dict(dropout=1.0), dict(straggler=-0.1), dict(corrupt=1.5),
               dict(shard_dropout=2.0), dict(shard_dropout_dwell=0),
               dict(straggler_delay=0), dict(corrupt_mode="zero"),
               dict(watchdog_norm=0.0), dict(max_rollbacks=-1)]


@pytest.mark.parametrize("kw", _BAD_FAULTS,
                         ids=[next(iter(k)) + str(i)
                              for i, k in enumerate(_BAD_FAULTS)])
def test_fault_config_errors_are_jax_s(kw):
    with pytest.raises(ValueError) as je:
        JFaultConfig(**kw)
    with pytest.raises(ValueError) as te:
        FaultConfig(**kw)
    assert str(te.value) == str(je.value)


def test_fault_config_fields_and_dict_coercion_match_jax():
    assert ([(f.name, f.default) for f in dataclasses.fields(FaultConfig)]
            == [(f.name, f.default)
                for f in dataclasses.fields(JFaultConfig)])
    cfg = ExperimentConfig(faults={"dropout": 0.1, "straggler": 0.2})
    assert cfg.faults == FaultConfig(dropout=0.1, straggler=0.2)
    assert not FaultConfig().enabled and FaultConfig(corrupt=0.1).enabled


def _jax_check(**kw):
    with pytest.raises(ValueError) as je:
        JF.check_fault_support(JConfig(**kw))
    return str(je.value)


def test_non_mask_aware_defense_error_is_jax_s():
    fc = dict(dropout=0.1)
    want = _jax_check(defense="GeoMedian", faults=JFaultConfig(**fc))
    # The port has no defense outside the mask-aware five, so the check
    # sees a config-like object naming one.
    cfg = types.SimpleNamespace(defense="GeoMedian",
                                faults=FaultConfig(**fc))
    with pytest.raises(ValueError) as te:
        F.check_fault_support(cfg)
    assert str(te.value) == want
    assert F.MASK_AWARE_DEFENSES == JF.MASK_AWARE_DEFENSES


def test_shard_dropout_on_a_flat_round_error_is_jax_s():
    want = _jax_check(faults=JFaultConfig(shard_dropout=0.1))
    cfg = ExperimentConfig(dataset=C.SYNTH_MNIST_HARD, users_count=7,
                           faults=FaultConfig(shard_dropout=0.1))
    with pytest.raises(ValueError) as te:
        FederatedExperiment(cfg, device="cpu")
    assert str(te.value) == want
    with pytest.raises(ValueError) as ce:
        cli.main(["-s", C.SYNTH_MNIST_HARD, "-n", "7", "-e", "1",
                  "--fault-shard-dropout", "0.1", "--device", "cpu"])
    assert str(ce.value) == want


def test_straggler_with_partial_participation_error_is_jax_s():
    want = _jax_check(participation=0.5,
                      faults=JFaultConfig(straggler=0.1))
    cfg = ExperimentConfig(faults=FaultConfig(straggler=0.1))
    with pytest.raises(ValueError) as te:
        F.check_fault_support(cfg, participation=0.5)
    assert str(te.value) == want
    F.check_fault_support(cfg)            # the port's full participation


def test_checkpoint_every_is_refused_until_the_lifecycle_slice():
    """The lifecycle slice has landed: any N >= 0 is accepted, and a
    negative one is refused with the JAX package's message."""
    assert ExperimentConfig(checkpoint_every=2).checkpoint_every == 2
    with pytest.raises(ValueError) as je:
        JConfig(checkpoint_every=-1)
    with pytest.raises(ValueError) as te:
        ExperimentConfig(checkpoint_every=-1)
    assert str(te.value) == str(je.value)


_FLAG_SETS = [[], ["--fault-dropout", "0.1", "--fault-straggler", "0.1"],
              ["--fault-corrupt", "0.05", "--fault-corrupt-mode", "scale",
               "--fault-straggler", "0.2", "--fault-straggler-delay", "3"],
              ["--fault-shard-dropout", "0.1",
               "--fault-shard-dropout-dwell", "4"]]


@pytest.mark.parametrize("flags", _FLAG_SETS,
                         ids=["none", "drop+strag", "corrupt", "shard"])
def test_cli_fault_flags_build_jax_s_fault_config(flags):
    targs = cli.build_parser().parse_args(["-d", "Median", *flags])
    jargs = jax_cli.build_parser().parse_args(["-d", "Median", *flags])
    got = cli.config_from_args(targs).faults
    want = jax_cli.config_from_args(jargs).faults
    if want is None:
        assert got is None
    else:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_cli_fault_flags_have_jax_s_names_and_defaults():
    def fault_actions(parser):
        return {a.dest: (a.option_strings, a.default, a.choices)
                for a in parser._actions if a.dest.startswith("fault_")}

    assert (fault_actions(cli.build_parser())
            == fault_actions(jax_cli.build_parser()))
    assert "Median" in next(a.choices for a in cli.build_parser()._actions
                            if a.dest == "defense")


def test_zero_rate_fault_config_is_the_clean_round():
    cfg = ExperimentConfig(dataset=C.SYNTH_MNIST_HARD, users_count=7,
                           synth_train=100, synth_test=20,
                           faults=FaultConfig())
    exp = FederatedExperiment(cfg, device="cpu")
    assert exp.faults is None and exp.fault_state is None
