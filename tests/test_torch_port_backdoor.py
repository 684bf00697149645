"""The port's clipped backdoor vs the JAX package's attacks/backdoor.py.

At a small size (SYNTH_MNIST_HARD 1,200/300, n = 19, f = 4, B = 32,
``mal_batch_size`` 64: a poison set of 19 batches, 95 shadow steps a
round), with both sides given the same explicit datasets and the JAX
init carried into the port as numpy:

- the poison set, bit for bit, for ``pattern`` and sample mode;
- the triggers;
- one shadow-trained craft against JAX's jitted ``_craft`` from the same
  weights, gradients and faded lr, both held to an fp64 craft of the same
  inputs (the rounding band a card-vs-CPU craft is held to), and the
  early-out branch;
- ``test_asr`` against JAX's ``test_asr``;
- three whole rounds of the port's engine against the JAX XLA engine
  under NoDefense, Krum and TrimmedMean, and the POST ASR after them;
- the BEFORE / Test set / POST lines of ``run()`` and of the CLI;
- the NaN guard, which raises in the craft seam with the server state
  finite at the last finished round.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from attacking_federate_learning_tpu import config as JC
from attacking_federate_learning_tpu.attacks.backdoor import (
    BackdoorAttack as JBackdoor
)
from attacking_federate_learning_tpu.config import ExperimentConfig as JConfig
from attacking_federate_learning_tpu.core.engine import (
    FederatedExperiment as JExperiment
)
from attacking_federate_learning_tpu.data import triggers as jtriggers
from attacking_federate_learning_tpu.data.datasets import (
    load_dataset as jax_load_dataset
)
from attacking_federate_learning_tpu_torch import cli
from attacking_federate_learning_tpu_torch import config as C
from attacking_federate_learning_tpu_torch.attacks import (
    AttackContext, cohort_stats, make_attacker
)
from attacking_federate_learning_tpu_torch.attacks.backdoor import (
    BackdoorAttack
)
from attacking_federate_learning_tpu_torch.config import ExperimentConfig
from attacking_federate_learning_tpu_torch.core.engine import (
    FederatedExperiment
)
from attacking_federate_learning_tpu_torch.core.server import (
    init_server_state
)
from attacking_federate_learning_tpu_torch.data import triggers
from attacking_federate_learning_tpu_torch.data.datasets import load_dataset
from attacking_federate_learning_tpu_torch.utils.weights import (
    from_jax_params
)

N, MAL_PROP, B, ROUNDS = 19, 0.22, 32, 3
SIZES = dict(synth_train=1200, synth_test=300)
KW = dict(dataset=C.SYNTH_MNIST_HARD, users_count=N, mal_prop=MAL_PROP,
          batch_size=B, epochs=ROUNDS, mal_batch_size=64, **SIZES)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """The port on two intra-op threads, for speed: beside the other test
    workers, a machine's every core per worker spins more than it
    computes.  The comparisons at the last bits take one thread
    (:func:`one_thread`); the others hold a band."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def datasets():
    return (jax_load_dataset(JC.SYNTH_MNIST_HARD, seed=0, **SIZES),
            load_dataset(C.SYNTH_MNIST_HARD, seed=0, **SIZES))


@pytest.fixture
def one_thread():
    """One CPU thread for a comparison at the last bits.  With several,
    the first shadow training of a process that has just run XLA's
    thread pool sometimes comes out up to 6.7e-6 away from every later
    one (seen in 3 of 9 processes; never with one thread): MKL picks a
    smaller thread count for a matmul while the cores are busy, and that
    changes its summation order, which 95 SGD steps and /lr amplify."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _attackers(datasets, backdoor="pattern", **kw):
    cfg = dict(KW, backdoor=backdoor, **kw)
    return (JBackdoor(JConfig(**cfg, aggregation_impl="xla"), datasets[0]),
            BackdoorAttack(ExperimentConfig(**cfg), datasets[1],
                           device="cpu"))


def _jax_init(datasets):
    """The JAX engine's initial weights, (numpy, port tensor)."""
    jexp = JExperiment(JConfig(**KW), dataset=datasets[0])
    w = np.asarray(jexp.state.weights)
    params = jax.tree.map(np.asarray, jexp.flat.unravel(jexp.state.weights))
    return w, from_jax_params(params)


def _cohort(d, f=4, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((f, d), dtype=np.float32) * np.float32(0.01)


@pytest.mark.parametrize("backdoor", ["pattern", "1", "3"])
@pytest.mark.parametrize("mal_batch_size,train", [(64, 1200), (200, 1200),
                                                  (16, 5000)])
def test_poison_set_is_jax_s_bit_for_bit(backdoor, mal_batch_size, train):
    sizes = dict(synth_train=train, synth_test=50)
    cfg = dict(dataset=C.SYNTH_MNIST_HARD, backdoor=backdoor,
               mal_batch_size=mal_batch_size, **sizes)
    ja = JBackdoor(JConfig(**cfg),
                   jax_load_dataset(JC.SYNTH_MNIST_HARD, seed=0, **sizes))
    ta = BackdoorAttack(ExperimentConfig(**cfg),
                        load_dataset(C.SYNTH_MNIST_HARD, seed=0, **sizes),
                        device="cpu")
    for got, want in ((ta.poison_x, ja.poison_x), (ta.poison_y, ja.poison_y),
                      (ta.poison_mask, ja.poison_mask)):
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ta.poison_x.numpy().view(np.uint32),
                                  np.asarray(ja.poison_x).view(np.uint32))
    assert ta.poison_count == ja.poison_count
    if backdoor == "pattern":
        # u = len // B // 10 strided: about ten batches of B.
        u = max(1, train // mal_batch_size // 10)
        assert ta.poison_count == len(range(0, train, u)) or (
            abs(ta.poison_count - train / u) <= 1)
        assert (ta.poison_y == 0).all()
    else:
        assert ta.poison_count == 1.0 and ta.poison_x.shape[:2] == (1, 1)


def test_triggers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 1, 28, 28), dtype=np.float32)
    y = rng.integers(0, 10, 6).astype(np.int32)
    tx = torch.from_numpy(x.copy())
    got = triggers.add_pattern(tx)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jtriggers.add_pattern(jnp.asarray(x))))
    assert np.array_equal(tx.numpy(), x)       # the caller's batch kept
    assert (got[..., :5, :5] == np.float32(2.8)).all()
    assert torch.equal(got[..., 5:, :], tx[..., 5:, :])
    assert torch.equal(got[..., :5, 5:], tx[..., :5, 5:])
    # Every channel of an NCHW batch.
    three = triggers.add_pattern(torch.zeros(2, 3, 8, 8))
    assert (three[:, :, :5, :5] == np.float32(2.8)).all()
    assert float(three.sum()) == pytest.approx(2 * 3 * 25 * 2.8, rel=1e-6)
    for mode in ("pattern", 1, 2):
        np.testing.assert_array_equal(
            triggers.backdoor_targets(torch.from_numpy(y), mode).numpy(),
            np.asarray(jtriggers.backdoor_targets(jnp.asarray(y), mode)))


def _clip_share(out, mean, sd, z=1.5):
    lo, hi = mean - z * sd, mean + z * sd
    return float(((out <= lo) | (out >= hi)).mean())


@pytest.mark.parametrize("backdoor", ["pattern", "1"])
def test_one_craft_matches_jax(backdoor, datasets, one_thread):
    """From the same weights, gradients and f32 faded lr, the shadow
    training (95 SGD steps for ``pattern``, 5 for sample mode) and the
    clip give JAX's crafted vector."""
    ja, ta = _attackers(datasets, backdoor)
    w, tw = _jax_init(datasets)
    G = _cohort(w.shape[0])
    lr = np.float32(1000.0) / np.float32(10002.0)     # round 2's faded lr
    want = np.asarray(ja._craft(jnp.asarray(G), jnp.asarray(w),
                                jnp.asarray(lr)))
    got = ta.craft(torch.from_numpy(G), AttackContext(tw, torch.tensor(lr),
                                                      2)).numpy()
    assert ta.early_outs == 0
    # The two frameworks' shadow nets drift apart by their backward
    # passes' rounding over the steps, and /lr scales the drift by 10;
    # measured worst difference 7.5e-8 on values up to 0.046, on one
    # thread; 5e-7 is several times that.
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-7)
    # The rounding band of the f32 pipeline: the same craft in fp64.
    # XLA's and MKL's matmuls round alike, so the two f32 crafts sit far
    # closer to each other than to fp64 (each 3.0e-6 from it for
    # 'pattern', 2.2e-7 for sample mode).  Two f32 crafts that round
    # differently, as the card's cuBLAS and the CPU do, may differ by up
    # to twice that distance: the band chip_smoke.py holds the card's
    # craft to against the CPU's.
    exact = _attackers(datasets, backdoor)[1]
    exact.poison_x = exact.poison_x.double()
    exact.poison_mask = exact.poison_mask.double()
    exact._count = exact._count.double()
    ref = exact.craft(torch.from_numpy(G).double(), AttackContext(
        tw.double(), torch.tensor(lr).double(), 2)).numpy()
    port64, jax64 = np.abs(got - ref).max(), np.abs(want - ref).max()
    assert 0 < port64 <= 2 * jax64 and 0 < jax64 <= 2 * port64
    assert np.abs(got - want).max() <= 2 * port64
    # About half the coordinates sit at a clip bound, each framework
    # measured against its own bounds; they disagree only where the
    # shadow value is within the drift of a bound.
    tmean, tsd = (t.numpy() for t in cohort_stats(torch.from_numpy(G)))
    jmean, jsd = np.asarray(G.mean(0)), np.asarray(jnp.std(G, axis=0))
    ts, js = _clip_share(got, tmean, tsd), _clip_share(want, jmean, jsd)
    assert 0.3 < ts < 0.7 and abs(ts - js) <= 1e-3


def test_craft_takes_the_early_out_where_jax_does(datasets, one_thread):
    """Weights that already put every poisoned example in the target
    class: no shadow training (JAX's lax.cond), the craft is the clipped
    (start - (start + lr*mean)) / lr."""
    ja, ta = _attackers(datasets, "pattern")
    w, _ = _jax_init(datasets)
    w = w.copy()
    w[-10] = 100.0                     # fc2's bias of class 0, the target
    G = _cohort(w.shape[0])
    lr = np.float32(0.1)
    _, correct = ta.poison_metrics(torch.from_numpy(w))
    assert float(correct) == ta.poison_count
    want = np.asarray(ja._craft(jnp.asarray(G), jnp.asarray(w),
                                jnp.asarray(lr)))
    got = ta.craft(torch.from_numpy(G), AttackContext(
        torch.from_numpy(w), torch.tensor(lr), 0)).numpy()
    assert ta.early_outs == 1
    # No training: both sides compute the same f32 algebra on means that
    # differ by their summation order, so start = w - lr*mean may round
    # one ulp of |w| apart, and (start - new) / lr carries two such ulps
    # divided by lr.
    tol = (4 * np.spacing(np.abs(w)) / lr
           + G.shape[0] * 1.2e-7 * np.abs(G).max())
    assert (np.abs(got - want) <= tol).all()
    # Short of 100 %, the shadow net trains.
    w[-10] = 0.0
    ta.craft(torch.from_numpy(G), AttackContext(torch.from_numpy(w),
                                                torch.tensor(lr), 0))
    assert ta.early_outs == 1


class _Lines:
    def __init__(self):
        self.lines = []

    def print(self, s):
        self.lines.append(s)


def test_test_asr_matches_jax(datasets):
    ja, ta = _attackers(datasets, "pattern")
    w, tw = _jax_init(datasets)
    for flat in (w, w * np.float32(0.5)):
        jl = _Lines()
        want = ja.test_asr(jnp.asarray(flat), logger=jl)
        lines = []
        got = ta.test_asr(torch.from_numpy(flat.copy()), lines.append)
        assert got == want
        jloss, jc = ja._poison_metrics(jnp.asarray(flat))
        tloss, tc = ta.poison_metrics(torch.from_numpy(flat.copy()))
        assert int(tc) == int(jc)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        # The JAX package's line, its float count ("1200.0") included.
        assert lines == jl.lines
        assert re.fullmatch(
            r"##Test malicious net: \[POST\] Average loss: \d+\.\d{4}, "
            r"Accuracy: \d+/1200\.0 \(\d+\.\d\d%\)", lines[0])


def _pair(defense, datasets, backdoor="pattern"):
    cfg = dict(KW, defense=defense, backdoor=backdoor)
    jcfg = JConfig(**cfg, aggregation_impl="xla", log_round_stats=True)
    jexp = JExperiment(jcfg, attacker=JBackdoor(jcfg, datasets[0]),
                       dataset=datasets[0])
    tcfg = ExperimentConfig(**cfg)
    texp = FederatedExperiment(
        tcfg, make_attacker(tcfg, datasets[1], device="cpu"), datasets[1],
        device="cpu")
    params = jax.tree.map(np.asarray, jexp.flat.unravel(jexp.state.weights))
    texp.state = init_server_state(from_jax_params(params))
    return jexp, texp


@pytest.mark.parametrize("defense", ["NoDefense", "Krum", "TrimmedMean"])
def test_three_backdoor_rounds_match_the_jax_engine(defense, datasets):
    jexp, texp = _pair(defense, datasets)
    assert texp.f == jexp.m_mal == 4
    winners = []
    if defense == "Krum":
        inner = texp.defense_fn

        def spy(grads, n, f, **kw):
            out = inner(grads, n, f, **kw)
            winners.append(np.flatnonzero((grads == out).all(1).numpy()))
            return out

        texp.defense_fn = spy
    for t in range(ROUNDS):
        jexp.run_round(t)
        texp.run_round(t)
        if defense == "Krum":
            # Krum picks one of the identical crafted rows, in both.
            won = int(jexp.last_round_stats["krum_selected"])
            assert won < texp.f and won in winners[t]
            assert set(winners[t]) == set(range(texp.f))
    want = np.asarray(jexp.state.weights)
    got = texp.state.weights.numpy()
    # Each round's crafted rows differ by the shadow training's drift
    # (test_one_craft_matches_jax: <= 1.5e-7), the honest rows by the
    # backward passes' ~1e-7 (tests/test_torch_port_round.py), and three
    # momentum steps at lr 0.1 carry both: measured at most 6.9e-8 (Krum,
    # whose winner is a crafted row); the ALIE round test's 1e-5 stands,
    # since with several threads one craft may move by up to 6.7e-6
    # (see ``one_thread``), 6.7e-7 after the server's lr.
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(texp.state.velocity.numpy(),
                               np.asarray(jexp.state.velocity), atol=1e-5)
    jl, jc = jexp.evaluate(jexp.state.weights)
    tl, tc = texp.evaluate(texp.state.weights)
    assert int(jc) == int(tc)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _, jpc = jexp.attacker._poison_metrics(jexp.state.weights)
    _, tpc = texp.attacker.poison_metrics(texp.state.weights)
    assert int(jpc) == int(tpc)


def test_run_prints_before_test_and_post_lines(datasets):
    tcfg = ExperimentConfig(**dict(KW, epochs=3, defense="TrimmedMean",
                                   backdoor="pattern"), test_step=2)
    att = make_attacker(tcfg, datasets[1], device="cpu")
    exp = FederatedExperiment(tcfg, att, datasets[1], device="cpu")
    w0 = exp.state.weights.clone()
    lines = []
    result = exp.run(log=lines.append)
    assert lines[0].startswith("\nBEFORE: Test set. Average loss: ")
    assert "Starting Training..." not in "".join(lines)
    # The BEFORE line is the evaluation of the initial weights.
    loss0, correct0 = exp.evaluate(w0)
    assert lines[0] == (
        "\nBEFORE: Test set. Average loss: {:.4f}, Accuracy: {}/300 "
        "({:.2f}%)".format(float(loss0), int(correct0),
                           100.0 * float(correct0) / 300))
    body = lines[1:-1]
    assert len(body) == 4 and result["epochs"] == [0, 2]
    for i, epoch in enumerate(result["epochs"]):
        assert body[2 * i].startswith(f"Test set: [{epoch:3d}]")
        assert body[2 * i + 1].startswith("##Test malicious net: [POST] ")
        acc = result["asr"][i]
        assert 0.0 <= acc <= 100.0
        assert body[2 * i + 1].endswith(f"({acc:.2f}%)")
    assert lines[-1].startswith("Max accuracy: ")
    assert result["asr"][-1] == att.test_asr(result["final_weights"])


def test_alie_runs_print_no_asr(datasets):
    tcfg = ExperimentConfig(**dict(KW, epochs=1))
    exp = FederatedExperiment(tcfg, make_attacker(tcfg, device="cpu"),
                              datasets[1], device="cpu")
    lines = []
    result = exp.run(log=lines.append)
    assert lines[0] == "\nStarting Training..." and "asr" not in result
    assert not any(s.startswith("##Test malicious") for s in lines)


def test_nan_guard_raises_in_the_craft_seam(datasets):
    """An absurd shadow lr overflows the shadow net: the craft raises the
    reference's error before anything is aggregated, and the server state
    is the last finished round's, finite (here round 0 raises, so it is
    the initial state)."""
    tcfg = ExperimentConfig(**dict(KW, epochs=4, defense="NoDefense",
                                   backdoor="pattern",
                                   mal_learning_rate=1e30))
    exp = FederatedExperiment(tcfg, make_attacker(tcfg, datasets[1],
                                                  device="cpu"),
                              datasets[1], device="cpu")
    finished = []
    inner = exp.run_round

    def counted(t):
        state = inner(t)
        finished.append((t, state.weights.clone()))
        return state

    exp.run_round = counted
    w0 = exp.state.weights.clone()
    with pytest.raises(FloatingPointError,
                       match="^Got nan in backdoor shadow training$"):
        exp.run(log=lambda s: None)
    last = finished[-1][1] if finished else w0
    assert exp.state.round == len(finished)
    assert torch.equal(exp.state.weights, last)
    assert bool(torch.isfinite(exp.state.weights).all())


@pytest.mark.parametrize("b,count", [("pattern", "200.0"), ("1", "1.0")])
def test_cli_backdoor_prints_before_post_and_max(b, count, capsys,
                                                 tmp_path):
    result = cli.main(["-s", C.SYNTH_MNIST_HARD, "-d", "Krum", "-n", "7",
                       "-m", "0.3", "-e", "3", "-c", "8", "-b", b,
                       "--test-step", "2", "--synth-train", "200",
                       "--synth-test", "40", "--device", "cpu",
                       "--log-dir", str(tmp_path / "logs"),
                       "--run-dir", str(tmp_path / "runs")])
    lines = [s for s in capsys.readouterr().out.splitlines() if s]
    i = next(k for k, s in enumerate(lines) if s.startswith("BEFORE: "))
    body = lines[i + 1:]
    assert [s.split(":")[0] for s in body] == [
        "Test set", "##Test malicious net", "Test set",
        "##Test malicious net", "Max accuracy"]
    assert all(f"/{count} (" in s for s in body if s.startswith("##"))
    assert len(result["asr"]) == 2
