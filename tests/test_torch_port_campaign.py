"""The port's campaign engine (campaigns/) against the JAX package's.

- One spec JSON expands in both packages to the same cells in the same
  order, with the same skip verdicts and the same grouping partition;
  the ids differ (they hash each package's config).  The port alone
  refuses ``remat=True``, the JAX fields its config lacks (``mesh_shape``,
  ``backend``: a TypeError at construction) and 'ring'/'allgather'
  distances under Krum and Bulyan (its engine's refusal without a mesh):
  :data:`PORT_ONLY`.
- The pre-check agrees with real construction in the port over the JAX
  package's known-invalid matrix (tests/test_campaign.py ``_INVALID``).
- Exactly once: a campaign killed mid-run in a subprocess and invoked
  again runs each cell once with zero duplicate registry stamps; a kill
  between a run's finish and its commit adopts the run.
- A deadline exits 75 and a resume completes the campaign.
- ``cfg_to_cli_args`` round-trips through the port's parser.
- Each inline cell's final weights are byte-equal to the same config run
  directly; the campaign's results equal the JAX campaign's on the same
  spec, both engines starting from the JAX engine's initial weights,
  within the whole-run tests' band (tests/test_torch_port_round.py:
  evaluation accuracy equal, test loss within rtol 1e-5).
- A campaign directory holding another expansion's journal (the JAX
  campaign of the same spec: same campaign id, same directory) is
  refused before any cell runs.
- With ``cache_dir`` the libraries' builds go there, whether the inline
  executor is named or given as an instance: on a cold directory only
  the first cell misses, the ambient directory is restored after,
  and a budget that evicts makes the next cell miss again.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from attacking_federate_learning_tpu.campaigns import (
    Campaign as JCampaign, CampaignSpec as JSpec
)
from attacking_federate_learning_tpu.campaigns import spec as JS
from attacking_federate_learning_tpu.campaigns.scheduler import (
    order_cells as j_order_cells
)
from attacking_federate_learning_tpu_torch import config as C
from attacking_federate_learning_tpu_torch.attacks import make_attacker
from attacking_federate_learning_tpu_torch.campaigns import (
    Campaign, CampaignJournal, CampaignSpec, Cell, cell_id_for,
    composition_reject_reason, config_signature
)
from attacking_federate_learning_tpu_torch.campaigns.scheduler import (
    EXIT_DEADLINE, InlineExecutor, order_cells
)
from attacking_federate_learning_tpu_torch.campaigns.spec import (
    verify_cli_round_trip
)
from attacking_federate_learning_tpu_torch.config import ExperimentConfig
from attacking_federate_learning_tpu_torch.core.engine import (
    FederatedExperiment
)
from attacking_federate_learning_tpu_torch.core.server import (
    init_server_state
)
from attacking_federate_learning_tpu_torch.data.datasets import load_dataset
from attacking_federate_learning_tpu_torch.ops import _build
from attacking_federate_learning_tpu_torch.utils.metrics import iter_events
from attacking_federate_learning_tpu_torch.utils.weights import (
    from_jax_params
)

from test_campaign import _INVALID, FakeClock, RecordingExecutor


def _base(tmp_path, **kw):
    kw.setdefault("dataset", C.SYNTH_MNIST)
    kw.setdefault("users_count", 12)
    kw.setdefault("mal_prop", 0.25)
    kw.setdefault("batch_size", 16)
    kw.setdefault("epochs", 2)
    kw.setdefault("synth_train", 256)
    kw.setdefault("synth_test", 64)
    kw.setdefault("log_dir", os.path.join(str(tmp_path), "logs"))
    kw.setdefault("run_dir", os.path.join(str(tmp_path), "runs"))
    return kw


# The cells the port alone refuses: (overrides, message fragment).
PORT_ONLY = [
    (dict(remat=True), "remat=True is not available in the port"),
    (dict(mesh_shape=[2, 1]), "unexpected keyword argument 'mesh_shape'"),
    (dict(backend="cpu"), "unexpected keyword argument 'backend'"),
    (dict(defense="Krum", distance_impl="ring"), "needs a device mesh"),
    (dict(defense="Bulyan", users_count=16, mal_prop=0.125,
          distance_impl="allgather"), "needs a device mesh"),
]

# The known-invalid matrix's cells that are port-only refusals too (the
# port's config has no mesh_shape).
_MATRIX_PORT_ONLY = {7}


def _partition(cells):
    groups = {}
    for i, c in enumerate(cells):
        groups.setdefault(c.group, set()).add(i)
    return sorted(sorted(g) for g in groups.values())


def test_one_spec_expands_alike_in_both_packages(tmp_path):
    blob = dict(
        name="both", base=_base(tmp_path),
        axes={"defense": ["NoDefense", "Krum", "Bulyan", "TrimmedMean"],
              "attack": ["none", "alie", "signflip"], "seed": [0, 1]},
        cells=[dict(aggregation="async", async_buffer=6,
                    defense="TrimmedMean"),
               dict(aggregation="hierarchical", megabatch=4,
                    defense="Median", tier2_defense="Krum",
                    _priority=5),
               dict(faults=dict(dropout=0.2), defense="Median"),
               dict(faults=dict(dropout=0.2), defense="DnC")]
        + [dict(o) for o, _ in PORT_ONLY],
        priorities={"defense=Krum": 2})
    text = json.dumps(blob)
    port, jax_spec = CampaignSpec.from_json(text), JSpec.from_json(text)
    assert port.campaign_id == jax_spec.campaign_id
    got, want = port.expand(), jax_spec.expand()
    assert len(got) == len(want) == 24 + 4 + len(PORT_ONLY)
    assert [(c.overrides, c.attack, c.priority, c.index) for c in got] == [
        (c.overrides, c.attack, c.priority, c.index) for c in want]
    port_only = range(28, 28 + len(PORT_ONLY))
    for i, (g, w) in enumerate(zip(got, want)):
        if i in port_only:
            assert g.skip is not None and w.skip is None
            assert PORT_ONLY[i - 28][1] in g.skip
        else:
            assert g.skip == w.skip
        assert g.cell_id != w.cell_id or g.cfg is None
    assert _partition(got[:28]) == _partition(want[:28])
    for mode in ("grouped", "spec", "shuffled"):
        a = order_cells(got[:28], mode, port.campaign_id)
        b = j_order_cells(want[:28], mode, jax_spec.campaign_id)
        assert [c.index for c in a] == [c.index for c in b]
    skipped = [c for c in got[:28] if c.skip]
    assert {(c.overrides["defense"], c.attack) for c in skipped} >= {
        ("Bulyan", "alie")}


def test_ids_and_signature(tmp_path):
    cfg = ExperimentConfig(**_base(tmp_path))
    assert cell_id_for(cfg, "alie") != cell_id_for(cfg, "signflip")
    assert cell_id_for(cfg, "auto") != cell_id_for(cfg, "alie")
    same = dataclasses.replace(cfg, epochs=8, checkpoint_every=5,
                               log_dir="elsewhere")
    assert config_signature(cfg) == config_signature(same)
    assert config_signature(cfg) != config_signature(
        dataclasses.replace(cfg, seed=1))
    assert config_signature(cfg) != config_signature(
        dataclasses.replace(cfg, defense="Krum"))
    assert config_signature(None) == "invalid"
    spec = CampaignSpec(name="dup", base=_base(tmp_path),
                        axes={"defense": ["Krum", "Krum"]})
    with pytest.raises(ValueError, match="duplicate cell id"):
        spec.expand()


@pytest.mark.parametrize("case", range(len(_INVALID)))
def test_precheck_agrees_with_construction(tmp_path, case):
    """The port's pre-check over JAX's known-invalid matrix: every cell
    is refused; where the JAX package refuses the same way, with its
    message; and real construction in the port raises exactly the
    pre-check's message (config-level or engine-level)."""
    overrides, attack, fragment = _INVALID[case]
    merged = _base(tmp_path, **overrides)
    reason = composition_reject_reason(merged, attack)
    assert reason is not None
    if case in _MATRIX_PORT_ONLY:
        assert "unexpected keyword argument 'mesh_shape'" in reason
    else:
        assert fragment in reason, (reason, fragment)
        assert reason == JS.composition_reject_reason(merged, attack)
    try:
        cfg = ExperimentConfig(**merged)
    except (ValueError, TypeError) as e:
        assert str(e) == reason
        return
    ds = load_dataset(cfg.dataset, seed=0, synth_train=256, synth_test=64)
    with pytest.raises(ValueError) as ei:
        FederatedExperiment(
            cfg, attacker=make_attacker(
                cfg, dataset=ds, name=None if attack == "auto" else attack,
                device="cpu"),
            dataset=ds, device="cpu")
    assert str(ei.value) == reason


@pytest.mark.parametrize("case", range(len(PORT_ONLY)))
def test_port_only_refusals_agree_with_construction(tmp_path, case):
    overrides, fragment = PORT_ONLY[case]
    merged = _base(tmp_path, **overrides)
    reason = composition_reject_reason(merged, "alie")
    assert fragment in reason
    assert JS.composition_reject_reason(merged, "alie") is None
    try:
        cfg = ExperimentConfig(**merged)
    except (ValueError, TypeError) as e:
        assert str(e) == reason
        return
    ds = load_dataset(cfg.dataset, seed=0, synth_train=256, synth_test=64)
    with pytest.raises(ValueError) as ei:
        FederatedExperiment(cfg, make_attacker(cfg, ds, "alie", "cpu"), ds,
                            device="cpu")
    assert str(ei.value) == reason


def test_cfg_to_cli_args_round_trip(tmp_path):
    cases = [
        _base(tmp_path),
        _base(tmp_path, defense="Krum", seed=3, partition="dirichlet",
              dirichlet_alpha=0.3, participation=0.5, mal_prop=0.5),
        _base(tmp_path, aggregation="hierarchical", megabatch=4,
              tier2_defense="Krum", mal_placement="concentrated",
              telemetry=True),
        _base(tmp_path, aggregation="async", async_buffer=8,
              staleness_weight="poly", defense="Krum"),
        _base(tmp_path, faults=dict(dropout=0.1, corrupt=0.05,
                                    corrupt_mode="scale"),
              defense="Median", checkpoint_every=2),
        _base(tmp_path, aggregation="hierarchical", megabatch=4,
              defense="TrimmedMean",
              faults=dict(dropout=0.1, shard_dropout=0.25,
                          shard_dropout_dwell=2)),
        _base(tmp_path, secagg="vanilla", defense="NoDefense",
              backdoor="pattern"),
        _base(tmp_path, defense="Bulyan", users_count=16, mal_prop=0.125,
              bulyan_selection_impl="host", data_placement="host_stream"),
        _base(tmp_path, defense="Krum", test_step=3, profile_every=2,
              margins=True, numerics=True,
              traffic=dict(population=50, diurnal_amp=0.5, seed=3)),
    ]
    for kw in cases:
        cfg = ExperimentConfig(**kw)
        for attack in ("auto", "alie"):
            cell = Cell(cell_id=cell_id_for(cfg, attack), overrides=kw,
                        attack=attack, cfg=cfg)
            assert verify_cli_round_trip(cell) is None, kw
    cfg = ExperimentConfig(**_base(tmp_path, momentum=0.5))
    cell = Cell(cell_id=cell_id_for(cfg, "auto"), overrides={},
                attack="auto", cfg=cfg)
    problem = verify_cli_round_trip(cell)
    assert problem is not None and "not expressible" in problem


# ---------------------------------------------------------------------------
# the deadline (the JAX tests' injected clock and recording executor;
# then the real CLI)

def test_deadline_stops_with_75_and_resumes(tmp_path):
    spec = CampaignSpec(name="dl", base=_base(tmp_path),
                        axes={"defense": ["NoDefense", "Krum", "Median",
                                          "TrimmedMean"]})
    clock = FakeClock()
    rec = RecordingExecutor(clock=clock, step=10.0)
    camp = Campaign(spec, executor=rec, journal_runs=False,
                    deadline_s=25.0, clock=clock)
    assert camp.run() == EXIT_DEADLINE == 75
    assert len(rec.cells) == 3
    man = camp.journal.read_manifest()
    assert man["status"] == "deadline"
    pending = [c for c, row in man["cells"].items()
               if row["state"] == "pending"]
    clock2 = FakeClock()
    rec2 = RecordingExecutor(clock=clock2, step=10.0)
    assert Campaign(spec, executor=rec2, journal_runs=False,
                    deadline_s=25.0, clock=clock2).run() == 0
    assert rec2.cells == pending
    j = CampaignJournal(camp.run_dir, spec.campaign_id)
    assert j.verify([c.cell_id for c in spec.expand()]) == []
    assert j.read_manifest()["status"] == "done" and j.attempt == 2


def test_deadline_through_the_cli(tmp_path):
    from attacking_federate_learning_tpu_torch.campaigns.cli import main

    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps(dict(
        name="cli_dl", base=_base(tmp_path, epochs=1),
        axes={"defense": ["NoDefense", "Krum"]})))
    argv = [str(spec), "--executor", "inline", "--device", "cpu"]
    assert main(argv + ["--deadline", "1e-9"]) == 75
    assert main(argv + ["--dry-run"]) == 0
    assert main(argv) == 0
    camp_dir = os.path.join(str(tmp_path), "runs", "campaigns")
    (cid,) = os.listdir(camp_dir)
    j = CampaignJournal(os.path.join(str(tmp_path), "runs"), cid)
    assert j.read_manifest()["counts"] == {"done": 2}
    assert j.attempt == 2


# ---------------------------------------------------------------------------
# exactly once across a SIGKILL (subprocesses, inline executor, CPU)

def _invoke(spec_path, env=None, expect=0):
    r = subprocess.run(
        [sys.executable, "-m", "attacking_federate_learning_tpu_torch.cli",
         "campaign", str(spec_path), "--executor", "inline", "--device",
         "cpu"], env=env or dict(os.environ), capture_output=True,
        text=True)
    assert r.returncode == expect, (r.returncode, r.stderr[-2000:])
    return r


def test_kill_and_resume_runs_each_cell_once(tmp_path):
    base = _base(tmp_path)
    blob = dict(name="kr", base=base,
                axes={"defense": ["Krum", "TrimmedMean"],
                      "attack": ["none", "alie"]})
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(json.dumps(blob))
    _invoke(spec_path, dict(os.environ, FL_CAMPAIGN_KILL_AFTER_CELLS="2"),
            expect=137)
    (cid,) = os.listdir(os.path.join(base["run_dir"], "campaigns"))
    assert len(CampaignJournal(base["run_dir"], cid).cells) == 2
    _invoke(spec_path)
    j = CampaignJournal(base["run_dir"], cid)
    spec = CampaignSpec.from_json(json.dumps(blob))
    assert j.verify([c.cell_id for c in spec.expand()]) == []
    assert j.read_manifest()["counts"] == {"done": 4} and j.attempt == 2
    by_attempt = {}
    for rec in j.records():
        if rec.get("kind") == "cell":
            by_attempt.setdefault(rec["attempt"], []).append(rec["cell"])
    assert len(by_attempt[1]) == len(by_attempt[2]) == 2
    with open(os.path.join(base["run_dir"], "index.jsonl")) as f:
        ids = [json.loads(line)["run_id"] for line in f]
    assert len(ids) == len(set(ids)) == 4
    events = list(iter_events(os.path.join(j.dir, "events.jsonl")))
    phases = [e["phase"] for e in events]
    assert phases.count("campaign_start") == 2
    assert phases.count("cell_done") == 4
    assert phases.count("campaign_done") == 1


def test_kill_before_commit_adopts_without_rerun(tmp_path):
    base = _base(tmp_path)
    spec_path = tmp_path / "spec.json"
    spec_path.write_text(json.dumps(dict(
        name="kb", base=base, axes={"defense": ["NoDefense", "Krum"]})))
    _invoke(spec_path, dict(os.environ, FL_CAMPAIGN_KILL_BEFORE_COMMIT="1"),
            expect=137)
    (cid,) = os.listdir(os.path.join(base["run_dir"], "campaigns"))
    assert CampaignJournal(base["run_dir"], cid).cells == {}
    idx = os.path.join(base["run_dir"], "index.jsonl")
    with open(idx) as f:
        assert len(f.readlines()) == 1
    _invoke(spec_path)
    j = CampaignJournal(base["run_dir"], cid)
    assert j.read_manifest()["counts"] == {"done": 2}
    assert len([r for r in j.cells.values() if r.get("adopted")]) == 1
    with open(idx) as f:
        ids = [json.loads(line)["run_id"] for line in f]
    assert len(ids) == len(set(ids)) == 2


# ---------------------------------------------------------------------------
# inline cells against direct runs, and against the JAX campaign

def test_inline_cells_are_direct_runs_byte_for_byte(tmp_path):
    spec = CampaignSpec(
        name="direct", base=_base(tmp_path, users_count=16,
                                  mal_prop=0.125, epochs=3),
        axes={"defense": ["Krum", "TrimmedMean", "Bulyan", "Median"],
              "attack": ["alie"]},
        cells=[dict(defense="Median", faults=dict(dropout=0.2,
                                                  corrupt=0.1))])
    weights = {}
    ex = InlineExecutor("cpu", on_engine=lambda cell, exp: weights.update(
        {cell.cell_id: exp.state.weights.clone()}))
    assert Campaign(spec, executor=ex).run() == 0
    ds = load_dataset(C.SYNTH_MNIST, seed=0, synth_train=256, synth_test=64)
    for cell in spec.expand():
        if cell.skip:
            continue
        exp = FederatedExperiment(
            cell.cfg, make_attacker(cell.cfg, ds, None if cell.attack
                                    == "auto" else cell.attack, "cpu"),
            ds, device="cpu")
        exp.run(log=lambda *_: None)
        assert torch.equal(weights[cell.cell_id], exp.state.weights), (
            cell.cell_id)
    assert len(weights) == 5


def _jax_init(cell):
    import jax

    from attacking_federate_learning_tpu.config import (
        ExperimentConfig as JConfig
    )
    from attacking_federate_learning_tpu.core.engine import (
        FederatedExperiment as JExperiment
    )
    jexp = JExperiment(JConfig(**cell.overrides))
    return init_server_state(from_jax_params(
        jax.tree.map(np.asarray, jexp.flat.unravel(jexp.state.weights))))


def _evals(path):
    return [(e["round"], e["accuracy"], e["test_loss"])
            for e in iter_events(path) if e["kind"] == "eval"]


def test_campaign_equals_jax_s_and_refuses_its_journal(tmp_path):
    blob = dict(name="vs_jax", base=_base(tmp_path, epochs=3),
                axes={"defense": ["Krum", "TrimmedMean"],
                      "attack": ["alie", "none"]})
    text = json.dumps(blob)
    jspec = JSpec.from_json(text)
    assert JCampaign(jspec, executor="inline").run() == 0
    jdir = os.path.join(blob["base"]["run_dir"], "campaigns",
                        jspec.campaign_id)
    with open(os.path.join(jdir, "journal.jsonl")) as f:
        jax_journal = f.read()
    # Same spec, same campaign id, same directory: refused before any
    # cell runs, and nothing written.
    spec = CampaignSpec.from_json(text)
    rec = RecordingExecutor()
    with pytest.raises(ValueError, match="cells this expansion lacks"):
        Campaign(spec, executor=rec).run()
    with pytest.raises(ValueError, match="cells this expansion lacks"):
        Campaign(spec, executor="inline", device="cpu").plan()
    assert rec.cells == []
    with open(os.path.join(jdir, "journal.jsonl")) as f:
        assert f.read() == jax_journal
    # In a run store of its own, from the JAX engine's initial weights.
    port_runs = str(tmp_path / "port_runs")
    port_logs = str(tmp_path / "port_logs")
    port_blob = dict(blob, base=dict(blob["base"], run_dir=port_runs,
                                     log_dir=port_logs))
    pspec = CampaignSpec.from_json(json.dumps(port_blob))
    inits = {}

    def start(cell, exp):
        jcell = dict(cell.overrides, run_dir=blob["base"]["run_dir"],
                     log_dir=blob["base"]["log_dir"])
        inits[cell.cell_id] = _jax_init(
            Cell(cell_id="", overrides=jcell))
        exp.state = inits[cell.cell_id]

    assert Campaign(pspec, executor=InlineExecutor(
        "cpu", on_start=start)).run() == 0
    jman = JCampaign(jspec).journal.read_manifest()
    pman = Campaign(pspec, device="cpu").journal.read_manifest()
    jrows = sorted(jman["cells"].values(), key=lambda r: r["index"])
    prows = sorted(pman["cells"].values(), key=lambda r: r["index"])
    assert len(jrows) == len(prows) == 4 and len(inits) == 4
    for jr, pr in zip(jrows, prows):
        assert (jr["defense"], jr["attack"], jr["state"]) == (
            pr["defense"], pr["attack"], pr["state"]) and pr["state"] == (
            "done")
        assert pr["final_accuracy"] == jr["final_accuracy"]
        got, want = _evals(pr["events"]), _evals(jr["events"])
        assert [g[:2] for g in got] == [w[:2] for w in want]
        np.testing.assert_allclose([g[2] for g in got],
                                   [w[2] for w in want], rtol=1e-5)


# ---------------------------------------------------------------------------
# the build directory

@pytest.mark.parametrize("named", [True, False],
                         ids=["named", "instance"])
def test_cache_dir_counts_and_budget(tmp_path, named):
    """Bulyan with the host selection engine loads the g++ library on the
    CPU: with a cold campaign build directory the first cell misses and
    the others hit, each cell running with the directory set and loading
    from it, whether the inline executor is named or given as an instance
    (with hooks); the ambient directory is back after.  A budget below
    the library's size evicts it after every cell, so every cell
    misses."""
    base = _base(tmp_path, users_count=16, mal_prop=0.125,
                 defense="Bulyan", bulyan_selection_impl="host")
    spec = CampaignSpec(name="cache", base=base, axes={"seed": [0, 1, 2]})
    cache = tmp_path / "cache"
    seen = []

    def done(cell, exp):
        lib = _build._LOADED["host:bulyan_select"]
        seen.append((_build.build_dir(), os.path.dirname(lib._name)))

    camp = Campaign(spec, executor="inline" if named else InlineExecutor(
        "cpu", on_engine=done), device="cpu", cache_dir=str(cache))
    assert camp.run() == 0
    assert seen == ([] if named else [(cache, str(cache))] * 3)
    assert _build.build_dir() == _build.BUILD_DIR
    man = camp.journal.read_manifest()
    rows = sorted(man["cells"].values(), key=lambda r: r["index"])
    assert [(r["cache_hits"], r["cache_misses"]) for r in rows] == [
        (0, 1), (1, 0), (1, 0)]
    assert man["cache"]["hits"] == 2 and man["cache"]["misses"] == 1
    assert man["cache"]["bytes"] > 0
    assert [p.suffix for p in cache.iterdir()] == [".so"]
    spec2 = CampaignSpec(name="budget", base=dict(base, run_dir=str(
        tmp_path / "runs2")), axes={"seed": [0, 1]})
    camp2 = Campaign(spec2, executor="inline", device="cpu",
                     cache_dir=str(tmp_path / "cache2"),
                     cache_budget_mb=1e-6)
    assert camp2.run() == 0
    rows = camp2.journal.read_manifest()["cells"].values()
    assert sorted((r["cache_hits"], r["cache_misses"]) for r in rows) == [
        (0, 1), (0, 1)]
    assert camp.child_env() == {_build.BUILD_DIR_ENV: str(cache)}
