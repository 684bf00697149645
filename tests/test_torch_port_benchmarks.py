"""The port's BASELINE runner (benchmarks.py) against the JAX package's.

- ``_cells()`` is the JAX package's: names, overrides, attacks and
  descriptions.
- ``run_cell('ref_default', ...)`` at 2 rounds and 4 clients in both
  packages, the port from the JAX engine's initial weights: the same
  keys, and final accuracies within one test sample.
- ``main``: ``--cells 9`` runs nothing; ``--strict`` raises
  ``SystemExit`` carrying ``.results`` when a cell fails and
  ``--no-strict`` returns them; the scale and the cells default by
  device (1.0 and 1-4 on the card, 0.1 and 1, 2, 4 on the CPU, with the
  JAX package's host trimmed means for cell 5 on the CPU).
"""

import jax
import numpy as np
import pytest
import torch

from attacking_federate_learning_tpu import benchmarks as JB
from attacking_federate_learning_tpu.config import (
    ExperimentConfig as JConfig
)
from attacking_federate_learning_tpu.core.engine import (
    FederatedExperiment as JExperiment
)
from attacking_federate_learning_tpu_torch import benchmarks as B
from attacking_federate_learning_tpu_torch.core import engine
from attacking_federate_learning_tpu_torch.core.server import (
    init_server_state
)
from attacking_federate_learning_tpu_torch.utils.weights import (
    from_jax_params
)

SYNTH = dict(synth_train=4096, synth_test=512)


def test_cells_are_jax_s():
    assert B._cells() == JB._cells()
    assert [c[0] for c in B._cells()] == [
        "ref_default", "mnist_cnn_krum_alie",
        "cifar10_resnet20_trimmed_backdoor", "cifar10_bulyan_alie_1000c",
        "noniid_10k_grid"]


def test_ref_default_cell_matches_jax_s(tmp_path, monkeypatch):
    name, overrides, attack, _ = B._cells()[0]
    want = JB.run_cell(name, overrides, attack, 2, 0.1,
                       str(tmp_path / "jax"))
    jexp = JExperiment(JConfig(**dict(overrides, users_count=4), epochs=2,
                               **SYNTH))
    init = jax.tree.map(np.asarray, jexp.flat.unravel(jexp.state.weights))

    class FromJaxInit(engine.FederatedExperiment):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.state = init_server_state(from_jax_params(init))

    monkeypatch.setattr(engine, "FederatedExperiment", FromJaxInit)
    got = B.run_cell(name, overrides, attack, 2, 0.1, str(tmp_path / "port"),
                     device="cpu")
    assert sorted(got) == sorted(want)
    for key in ("cell", "clients", "rounds", "dataset", "model"):
        assert got[key] == want[key], key
    assert got["clients"] == 4
    assert abs(got["final_accuracy"] - want["final_accuracy"]) <= (
        100 / SYNTH["synth_test"])
    assert got["rounds_per_sec"] > 0 and got["setup_s"] >= 0


def _recording(monkeypatch, fail=()):
    calls = []

    def run_cell(name, overrides, attack, rounds, scale, log_dir, device):
        calls.append((name, overrides, scale, device))
        if name in fail:
            raise RuntimeError("boom")
        return {"cell": name}

    monkeypatch.setattr(B, "run_cell", run_cell)
    return calls


def test_unknown_cell_runs_nothing(monkeypatch):
    calls = _recording(monkeypatch)
    assert B.main(["--cells", "9", "--device", "cpu"]) == []
    assert calls == []


def test_strict_raises_with_the_results_and_no_strict_returns(monkeypatch):
    _recording(monkeypatch, fail=("mnist_cnn_krum_alie",))
    argv = ["--cells", "1,2", "--device", "cpu"]
    with pytest.raises(SystemExit) as ei:
        B.main(argv)
    assert "1 cell(s) failed: mnist_cnn_krum_alie" in str(ei.value)
    assert ei.value.results == [
        {"cell": "ref_default"},
        {"cell": "mnist_cnn_krum_alie", "failed": "RuntimeError: boom"}]
    assert B.main(argv + ["--no-strict"]) == ei.value.results


def test_defaults_follow_the_device(monkeypatch):
    calls = _recording(monkeypatch)
    B.main(["--device", "cpu"])
    assert [(c[0], c[2], c[3]) for c in calls] == [
        (n, 0.1, "cpu") for n in ("ref_default", "mnist_cnn_krum_alie",
                                  "cifar10_bulyan_alie_1000c")]
    calls.clear()
    B.main(["--device", "cpu", "--cells", "5"])
    assert calls[0][1]["trimmed_mean_impl"] == "host"
    assert calls[0][1]["bulyan_trim_impl"] == "host"
    # On a card (resolved as one here): scale 1.0, cells 1-4, and cell 5
    # keeps the card's trimmed means.
    monkeypatch.setattr(engine, "resolve_device",
                        lambda device: torch.device(device))
    calls.clear()
    B.main([])
    assert [(c[0], c[2], c[3]) for c in calls] == [
        (n, 1.0, "cuda") for n, *_ in B._cells()[:4]]
    calls.clear()
    B.main(["--cells", "5", "--scale", "0.5"])
    assert calls[0][2] == 0.5 and calls[0][1] == B._cells()[4][1]
