"""The port's ``runs`` verbs (runs_cli.py) against the JAX package's, on a
store that holds both packages' runs (tests/_torch_port_stores.py).

Every verb (``list show diff compare tag trace forensics async traffic
campaign attribution walls margins numerics selfcheck``), on each
package's runs and across them, prints what the JAX package's prints,
line for line, with ``--json`` and without, and exits alike; so does
``diff_trajectories`` with its f32 ulp band.

Stated difference: a port run's 'wall' and 'stage_cost' events are
named by the port's entry points (utils/walls.py, utils/costs.py), not
JAX's programs.  Both readers key on the names a run wrote, so they
agree on it; ``runs walls`` and ``runs attribution`` are also held to
the port run's own records (``exp.wall_records`` and the cost ledger).
"""

import contextlib
import io
import json
import os

import pytest

from attacking_federate_learning_tpu import runs_cli as JRC
from attacking_federate_learning_tpu_torch import cli
from attacking_federate_learning_tpu_torch import config as C
from attacking_federate_learning_tpu_torch import runs_cli as RC
from attacking_federate_learning_tpu_torch.attacks import DriftAttack
from attacking_federate_learning_tpu_torch.config import ExperimentConfig
from attacking_federate_learning_tpu_torch.core.engine import (
    FederatedExperiment
)
from attacking_federate_learning_tpu_torch.data.datasets import load_dataset
from attacking_federate_learning_tpu_torch.utils.costs import STAGES
from attacking_federate_learning_tpu_torch.utils.lifecycle import RunJournal
from attacking_federate_learning_tpu_torch.utils.metrics import (
    RunLogger, iter_events
)
from attacking_federate_learning_tpu_torch.utils.registry import RunRegistry

from _torch_port_stores import capture, RUNS, run_ids, shared_store, store_copy

VERBS = ("show", "trace", "forensics", "async", "traffic", "attribution",
         "walls", "margins", "numerics")
PAIR_VERBS = ("diff", "compare", "attribution", "walls", "margins",
              "numerics")


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return shared_store(tmp_path_factory)


@pytest.fixture(scope="module")
def runs(store, tmp_path_factory):
    """A refreshed copy of the store's runs/ (the verbs only read it)."""
    runs = store_copy(store, tmp_path_factory.mktemp("runs_verbs"))
    RunRegistry(runs).refresh(bench=[], progress=[])
    return runs


def _both(runs, argv):
    head = ["--run-dir", runs, "--bench", "", "--progress", ""]
    got = capture(RC.main, head + argv)
    want = capture(JRC.main, head + argv)
    assert got == want, argv
    return got


@pytest.mark.parametrize("verb", VERBS)
@pytest.mark.parametrize("rid", run_ids())
def test_single_run_verbs_equal_jax_s(runs, tmp_path, verb, rid):
    extra = (["-o", str(tmp_path / "t.json")] if verb == "trace" else [])
    for js in ([], ["--json"]):
        rc, lines = _both(runs, js + [verb, rid] + extra)
        assert lines, (verb, rid)
    if verb == "trace":
        assert lines == [f"wrote {tmp_path / 't.json'} (load in "
                         f"chrome://tracing or ui.perfetto.dev)"]


@pytest.mark.parametrize("verb", PAIR_VERBS)
@pytest.mark.parametrize("name", list(RUNS))
def test_two_run_verbs_across_packages(runs, verb, name):
    for js in ([], ["--json"]):
        _both(runs, js + [verb, f"j_{name}", f"p_{name}"])


def test_diff_band_names_the_divergence_alike(runs):
    for a, b in (("p_obs", "p_plain"), ("j_obs", "j_plain"),
                 ("j_obs", "p_obs")):
        for band in ("0", "4", "100000"):
            rc, lines = _both(runs, ["diff", "--band", band, a, b])
            assert rc == 0
            _both(runs, ["--json", "diff", "--band", band, a, b])


def test_diff_trajectories_equal_jax_s(store):
    def events(rid):
        return list(iter_events(os.path.join(store, "logs", rid + ".jsonl"),
                                validate=False, skip_bad=True))

    for a, b in (("p_obs", "j_obs"), ("p_obs", "p_obs"),
                 ("p_faulted", "j_faulted")):
        for band in (0, 1, 64):
            got = RC.diff_trajectories(events(a), events(b), band=band)
            assert got == JRC.diff_trajectories(events(a), events(b),
                                                band=band)
    same = RC.diff_trajectories(events("p_obs"), events("p_obs"))
    assert same["divergence_round"] is None


def test_list_compare_campaign_selfcheck(runs):
    rc, lines = _both(runs, ["list"])
    assert rc == 0 and len(lines) == len(run_ids()) + 1
    rc, lines = _both(runs, ["--json", "--filter", "defense=Krum", "list"])
    assert {e["defense"] for e in json.loads(lines[-1])} == {"Krum"}
    _both(runs, ["compare"] + run_ids())
    _both(runs, ["campaign"])
    rc, lines = _both(runs, ["selfcheck"])
    assert rc == 0 and lines[-1].startswith("ok   selfcheck")


def test_tag_and_unknown_run(store, tmp_path):
    a = store_copy(store, tmp_path / "a")
    b = store_copy(store, tmp_path / "b")
    head = ["--bench", "", "--progress", ""]
    got = capture(RC.main, ["--run-dir", a] + head + ["tag", "p_hier",
                                                       "golden"])
    want = capture(JRC.main, ["--run-dir", b] + head + ["tag", "p_hier",
                                                         "golden"])
    assert got == want == (0, ["tagged p_hier as 'golden'"])
    assert RunRegistry(a).resolve("golden")["run_id"] == "p_hier"
    for runs_dir, fn in ((a, RC.main), (b, JRC.main)):
        rc, lines = capture(fn, ["--run-dir", runs_dir] + head
                             + ["show", "nope"])
        assert rc == 2
    assert (capture(RC.main, ["--run-dir", a] + head + ["show", "nope"])[1]
            == [line.replace(b, a) for line in capture(
                JRC.main, ["--run-dir", b] + head + ["show", "nope"])[1]])


def test_stale_index_warning(store, tmp_path):
    runs = store_copy(store, tmp_path)
    RunRegistry(runs).refresh()
    man = os.path.join(runs, "p_plain", "manifest.json")
    idx = os.path.join(runs, "index.jsonl")
    os.utime(idx, (os.path.getmtime(man) - 5,) * 2)
    rc, lines = _both(runs, ["list", "--no-refresh"])
    assert "WARNING" in lines[0] and "stale" in lines[0]


def test_cli_dispatch_and_trace_verb(runs, tmp_path):
    out = tmp_path / "t.json"
    rc, lines = capture(cli.main, ["runs", "--run-dir", runs, "--bench",
                                    "", "--progress", "", "trace",
                                    "p_hier", "-o", str(out)])
    assert rc == ("exit", 0) and out.exists()
    with open(out) as f:
        assert json.load(f)["traceEvents"]
    # The trace verb lives under 'runs' only.
    with pytest.raises(SystemExit) as bad:
        with contextlib.redirect_stderr(io.StringIO()):
            cli.main(["trace", str(out)])
    assert bad.value.code == 2


# ---------------------------------------------------------------------------
# runs walls / attribution against the port run's own records

def _median(vals):
    vals = sorted(vals)
    return vals[len(vals) // 2]


@pytest.fixture(scope="module")
def own_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("own")
    cfg = ExperimentConfig(dataset=C.SYNTH_MNIST, users_count=8,
                           mal_prop=0.25, batch_size=16, epochs=4,
                           test_step=2, synth_train=200, synth_test=40,
                           defense="Krum",
                           profile_every=1, log_dir=str(tmp / "logs"),
                           run_dir=str(tmp / "runs"))
    ds = load_dataset(cfg.dataset, seed=0, synth_train=200, synth_test=40)
    exp = FederatedExperiment(cfg, DriftAttack(1.5), ds, device="cpu")
    with RunLogger(cfg, log_dir=cfg.log_dir, jsonl_name="own") as logger:
        ledger = exp.cost_report(logger)
        exp.run(logger, journal=RunJournal(cfg.run_dir, "own"))
    RunRegistry(cfg.run_dir).refresh()
    return cfg, exp, ledger


def test_walls_are_the_runs_own_records(own_run):
    cfg, exp, _ = own_run
    rc, lines = _both(cfg.run_dir, ["--json", "walls", "own"])
    got = json.loads(lines[-1])["own"]
    names = {r.name for r in exp.wall_records}
    assert set(got["entries"]) == names and names
    for name, agg in got["entries"].items():
        recs = [r for r in exp.wall_records if r.name == name]
        assert agg["captures"] == len(recs)
        assert agg["unattributed_us"] == _median(
            [round(r.unattributed_us, 3) for r in recs])
        for stage in STAGES:
            vals = [round(r.stages.get(stage, 0.0), 3) for r in recs]
            if any(v > 0 for v in vals):
                assert agg["stages"][stage] == _median(vals)
            else:
                assert stage not in agg["stages"]
    _both(cfg.run_dir, ["walls", "own"])


def test_attribution_is_the_runs_own_ledger(own_run):
    cfg, _, ledger = own_run
    rc, lines = _both(cfg.run_dir, ["--json", "attribution", "own"])
    got = json.loads(lines[-1])["own"]
    want = {r.name: r.stage_event() for r in ledger.records
            if r.stage_event() is not None}
    assert set(got["stages"]) == set(want) and want
    for name, ev in got["stages"].items():
        assert {k: v for k, v in ev.items() if k not in ("t", "v")} == (
            json.loads(json.dumps(want[name], default=str)))
    assert got["wire"]["total_bytes"] == ledger.wire["total_bytes"]
    _both(cfg.run_dir, ["attribution", "own"])


def test_campaign_verb_over_a_port_campaign(tmp_path):
    from attacking_federate_learning_tpu_torch.campaigns import (
        Campaign, CampaignSpec
    )

    base = dict(dataset=C.SYNTH_MNIST, users_count=8, mal_prop=0.25,
                batch_size=16, epochs=2, synth_train=200, synth_test=40,
                log_dir=str(tmp_path / "logs"),
                run_dir=str(tmp_path / "runs"))
    spec = CampaignSpec(name="verb", base=base,
                        axes={"defense": ["Krum", "Bulyan"],
                              "attack": ["alie"]})
    assert Campaign(spec, executor="inline", device="cpu").run() == 0
    runs = base["run_dir"]
    rc, lines = _both(runs, ["campaign"])
    assert rc == 0 and lines[0].startswith(spec.campaign_id)
    for js in ([], ["--json"]):
        rc, lines = _both(runs, js + ["campaign", spec.campaign_id[:6]])
        assert rc == 0
    table = json.loads(lines[-1])["table"]
    assert table["rows"] == ["Krum", "Bulyan"]
    (skip,) = table["cells"]["Bulyan|alie"]
    assert skip["state"] == "skipped" and "4*corrupted_count" in skip[
        "reason"]
    (done,) = table["cells"]["Krum|alie"]
    with open(os.path.join(runs, done["cell"], "manifest.json")) as f:
        man = json.load(f)
    assert done["source"] == "registry"
    assert done["final_accuracy"] == man["final_accuracy"]


def test_the_verbs_are_jax_s_fifteen():
    assert _verbs(RC) == _verbs(JRC) == sorted(
        ["list", "show", "diff", "compare", "tag", "trace", "forensics",
         "async", "traffic", "campaign", "attribution", "walls",
         "margins", "numerics", "selfcheck"])


def _verbs(mod):
    rc, lines = capture(mod.main, ["--help"])
    text = " ".join(lines)
    start = text.index("{") + 1
    return sorted(text[start:text.index("}", start)].split(","))
