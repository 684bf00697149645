"""The port's grid runner (grid.py), a thin campaign wrapper, against the
JAX package's.

- ``grid_spec`` over the port's DEFENSES and ATTACKS registries expands
  to the JAX grid's cells in the same order with the same skips (the two
  registries hold the same names);
- ``run_grid`` on the CPU keeps the historical summary: one JSON line a
  cell as it finishes, the JAX grid's row keys, composition rejections
  recorded as skipped cells, each row joined by its cell id; with
  ``--journal`` a re-invoke runs nothing again;
- ``python -m attacking_federate_learning_tpu_torch.grid`` runs with
  ``--device cpu``, and the grid defaults to the card.
"""

import inspect
import json
import os
import subprocess
import sys

import pytest

from attacking_federate_learning_tpu import grid as JG
from attacking_federate_learning_tpu.config import ExperimentConfig as JConfig
from attacking_federate_learning_tpu_torch import config as C
from attacking_federate_learning_tpu_torch import grid as G
from attacking_federate_learning_tpu_torch.config import ExperimentConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _base(cls, tmp_path, **kw):
    return cls(**{**dict(dataset=C.SYNTH_MNIST, users_count=10,
                         mal_prop=0.24, batch_size=16, epochs=2,
                         synth_train=256, synth_test=64,
                         log_dir=str(tmp_path / "logs"),
                         run_dir=str(tmp_path / "runs")), **kw})


def test_grid_spec_expands_as_jax_s(tmp_path):
    assert G._all_defenses() == JG._all_defenses()
    assert G._all_attacks() == JG._all_attacks()
    got = G.grid_spec(_base(ExperimentConfig, tmp_path)).expand()
    want = JG.grid_spec(_base(JConfig, tmp_path)).expand()
    assert len(got) == len(want) == 10 * 8
    # The JAX base carries backend; the rest is shared.
    for g, w in zip(got, want):
        w_over = {k: v for k, v in w.overrides.items() if k != "backend"}
        assert (g.overrides, g.attack, g.index) == (w_over, w.attack,
                                                    w.index)
        assert (g.skip is None) == (w.skip is None)
        if g.skip is not None:
            assert g.skip == w.skip
    assert got[0].cfg.mal_prop == 0.0 and got[0].cfg.num_std == 0.0


def test_run_grid_rows_and_skip(tmp_path):
    base = _base(ExperimentConfig, tmp_path)
    out = tmp_path / "summary.jsonl"
    rows = G.run_grid(base, ["NoDefense", "Bulyan"], ["none", "alie"],
                      out_path=str(out), device="cpu")
    assert [(r["defense"], r["attack"]) for r in rows] == [
        ("NoDefense", "none"), ("NoDefense", "alie"), ("Bulyan", "none"),
        ("Bulyan", "alie")]
    (skip,) = [r for r in rows if "skipped" in r]
    assert (skip["defense"], skip["attack"]) == ("Bulyan", "alie")
    assert "4*corrupted_count" in skip["skipped"]
    ran = [r for r in rows if "final_accuracy" in r]
    assert len(ran) == 3
    assert all(set(r) >= {"defense", "attack", "run_id", "final_accuracy",
                          "max_accuracy", "rounds", "wall_s"} for r in ran)
    assert len({r["run_id"] for r in rows}) == 4
    with open(out) as f:
        assert [json.loads(line) for line in f] == rows
    # Ephemeral by default: nothing under runs/.
    assert not os.path.exists(base.run_dir)


def test_run_grid_row_shape_is_jax_s(tmp_path):
    jrows = JG.run_grid(_base(JConfig, tmp_path / "j"), ["Krum"],
                        ["none", "alie"],
                        out_path=str(tmp_path / "j.jsonl"))
    prows = G.run_grid(_base(ExperimentConfig, tmp_path / "p"), ["Krum"],
                       ["none", "alie"], out_path=str(tmp_path / "p.jsonl"),
                       device="cpu")
    assert [sorted(r) for r in prows] == [sorted(r) for r in jrows]
    assert [r["rounds"] for r in prows] == [r["rounds"] for r in jrows]


def test_journaled_grid_resumes_to_nothing(tmp_path):
    base = _base(ExperimentConfig, tmp_path, epochs=1)
    first = G.run_grid(base, ["Krum", "Median"], ["alie"], journal=True,
                       out_path=str(tmp_path / "a.jsonl"), device="cpu")
    assert len(first) == 2 and os.path.isdir(os.path.join(
        base.run_dir, "campaigns"))
    again = G.run_grid(base, ["Krum", "Median"], ["alie"], journal=True,
                       out_path=str(tmp_path / "b.jsonl"), device="cpu")
    assert again == []
    with open(os.path.join(base.run_dir, "index.jsonl")) as f:
        assert len(f.readlines()) == 2


def test_module_entry_point_on_the_cpu(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "attacking_federate_learning_tpu_torch.grid",
         "-e", "1", "-n", "8", "-m", "0.25", "-c", "16", "--synth-train",
         "128", "--synth-test", "32", "--defenses", "Krum", "--attacks",
         "alie", "--device", "cpu", "--log-dir", str(tmp_path / "logs"),
         "--out", str(tmp_path / "s.jsonl")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    (row,) = [json.loads(line) for line in
              (tmp_path / "s.jsonl").read_text().splitlines()]
    assert (row["defense"], row["attack"], row["rounds"]) == (
        "Krum", "alie", 1)


def test_the_grid_defaults_to_the_card():
    assert inspect.signature(G.run_grid).parameters["device"].default == (
        "cuda")
    with pytest.raises(SystemExit):
        G.main(["--device", "tpu"])
