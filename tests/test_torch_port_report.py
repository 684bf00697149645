"""The port's run report (report.py) against the JAX package's, on the
event logs of a store that holds both packages' runs
(tests/_torch_port_stores.py): every summary dict equal, every printed
line equal, the JSON equal, one log at a time and all at once.

Stated difference: a port run's 'compile' events are kernel libraries
(platform 'cuda', ops/_build.py), not XLA programs.  On such events the
port's ``compile_cost`` adds ``kernel_libraries: True`` and heads its
table "kernel libraries & cost"; the rest of the dict is the JAX
reader's, and the counts are held to the port's own cost ledger
(utils/costs.py ``CompileLedger``).  On the CPU no library is built, so
the store's port runs carry no 'compile' event.
"""

import json
import os

import pytest

from attacking_federate_learning_tpu import report as JR
from attacking_federate_learning_tpu_torch import report as R
from attacking_federate_learning_tpu_torch.utils.costs import CompileLedger
from attacking_federate_learning_tpu_torch.utils.registry import RunRegistry

from _torch_port_stores import capture, run_ids, shared_store, store_copy


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return shared_store(tmp_path_factory)


def _log(store, rid):
    return os.path.join(store, "logs", rid + ".jsonl")


@pytest.mark.parametrize("rid", run_ids())
def test_summary_and_text_equal_jax_s(store, rid):
    path = _log(store, rid)
    got = R.summarize_run(R.load_events([path]))
    assert got == JR.summarize_run(JR.load_events([path]))
    assert got["events"] > 0 and "accuracy" in got
    for flags in ([], ["--json"], ["--no-validate", "--skip-bad"]):
        assert (capture(R.main, [path] + flags)
                == capture(JR.main, [path] + flags))


def test_every_summary_section_is_read(store):
    s = {rid: R.summarize_run(R.load_events([_log(store, rid)]))
         for rid in run_ids()}
    for pkg in ("j", "p"):
        obs = s[f"{pkg}_obs"]
        assert {"selection", "numerics", "compile_cost"} <= set(obs)
        assert "stream" in s[f"{pkg}_plain"]
        assert s[f"{pkg}_faulted"]["faults"]["rounds"] == 3
        assert s[f"{pkg}_async"]["async"]["rounds"] == 3
        assert "forensics" in s[f"{pkg}_hier"]
        assert s[f"{pkg}_plain"]["stream"]["stream_gets"] > 0


def test_all_logs_at_once(store):
    paths = [_log(store, rid) for rid in run_ids()]
    got = capture(R.main, paths)
    assert got == capture(JR.main, paths)
    assert "== selection concentration across runs ==" in got[1]
    assert (capture(R.main, ["--json"] + paths)
            == capture(JR.main, ["--json"] + paths))


def test_forensics_equal_jax_s(store, tmp_path):
    paths = [_log(store, rid) for rid in ("j_hier", "p_hier")]
    for flags in ([], ["--json"]):
        got = capture(R.main, ["forensics"] + paths + flags)
        assert got == capture(JR.main, ["forensics"] + paths + flags)
        assert got[0] == 0
    # A flat run has no shard_selection stream: exit 1, named.
    flat = _log(store, "p_obs")
    got = capture(R.forensics_main, [flat])
    assert got == capture(JR.forensics_main, [flat]) and got[0] == 1
    out_p, out_j = tmp_path / "p.jsonl", tmp_path / "j.jsonl"
    R.forensics_main(paths + ["--events", str(out_p), "--json"])
    JR.forensics_main(paths + ["--events", str(out_j), "--json"])

    def verdicts(p):
        with open(p) as f:
            return [{k: v for k, v in json.loads(line).items() if k != "t"}
                    for line in f]
    assert verdicts(out_p) == verdicts(out_j)
    assert len(verdicts(out_p)) == 2


def test_run_id_resolution(store, tmp_path):
    runs = store_copy(store, tmp_path)
    RunRegistry(runs).refresh()
    argv = ["--run-id", "p_async", "--run-id", "j_faulted",
            "--run-dir", runs]
    got = capture(R.main, argv)
    assert got == capture(JR.main, argv)
    assert got[1][0] == f"== {_log(store, 'p_async')} =="
    with pytest.raises(ValueError, match="no run matching 'nope'"):
        R.main(["--run-id", "nope", "--run-dir", runs])


def test_torn_and_mixed_version_logs(store, tmp_path):
    path = tmp_path / "torn.jsonl"
    with open(_log(store, "p_obs")) as f:
        text = f.read()
    path.write_text(text + '{"kind": "eval", "round"\n'
                    + json.dumps({"kind": "wall", "v": 3, "name": "x",
                                  "source": "trace", "wall_s": 1.0})
                    + "\n")
    argv = [str(path), "--skip-bad"]
    got = capture(R.main, argv)
    assert got == capture(JR.main, argv)
    assert "2 torn/invalid line(s) skipped" in got[1][1]
    with pytest.raises(ValueError):
        R.load_events([str(path)])


def test_campaign_table_equal_jax_s():
    man = {"campaign_id": "c", "status": "done", "cells": {
        "a": {"defense": "Krum", "attack": "alie", "state": "done",
              "final_accuracy": 51.5, "wall_s": 3.0},
        "b": {"defense": "Krum", "attack": "none", "state": "skipped",
              "reason": "nope"},
        "c": {"defense": "Median", "attack": "alie", "state": "failed",
              "reason": "rc=1"},
        "d": {"defense": "Median", "attack": "none", "state": "pending"}}}
    reg = {"a": {"final_accuracy": 52.25, "rounds_per_s": 7.5}}
    for entries in (None, {}, reg):
        got = R.campaign_table(man, entries)
        assert got == JR.campaign_table(man, entries)
        lines_p, lines_j = [], []
        R._print_campaign_table(got, lines_p.append)
        JR._print_campaign_table(got, lines_j.append)
        assert lines_p == lines_j
    assert R.campaign_table(man, reg)["cells"]["Krum|alie"][0][
        "final_accuracy"] == 52.25


def test_compile_table_of_kernel_libraries():
    """The port's 'compile' events, from its own ledger: the JAX reader's
    dict plus ``kernel_libraries``, and a header that says so."""
    ledger = CompileLedger()
    ledger.add_compiles({"krum_scores": {"compile_s": 1.25, "cache": "miss"},
                         "median": {"compile_s": 0.0, "cache": "hit"}})
    events = []

    class Sink:
        def record(self, **rec):
            events.append(dict(rec, v=14))

    ledger.emit(Sink())
    got, want = R.compile_cost(events), JR.compile_cost(events)
    assert got.pop("kernel_libraries") is True
    assert got == want
    assert got["cache_hits"] == sum(r.cache == "hit"
                                    for r in ledger.compiles) == 1
    assert got["cache_misses"] == 1 and got["compile_total_s"] == 1.25
    assert [r["name"] for r in got["entries"]] == [
        r.name for r in ledger.compiles]
    lines = []
    R._print_run("x", {"events": 2, "compile_cost": R.compile_cost(events)},
                 lines.append)
    assert lines[2] == ("  kernel libraries & cost (1.25 s total nvcc "
                        "build; build directory 1 hit / 1 miss):")
    # A JAX run's compile events keep the JAX header.
    xla = [dict(e, platform="tpu") for e in events]
    assert "kernel_libraries" not in R.compile_cost(xla)
    lines = []
    R._print_run("x", {"events": 2, "compile_cost": R.compile_cost(xla)},
                 lines.append)
    jlines = []
    JR._print_run("x", {"events": 2, "compile_cost": JR.compile_cost(xla)},
                  jlines.append)
    assert lines == jlines


def test_cli_dispatch(store):
    from attacking_federate_learning_tpu_torch import cli

    path = _log(store, "p_traffic")
    got = capture(cli.main, ["report", path])
    assert got[0] == ("exit", 0)
    assert got[1] == capture(JR.main, [path])[1]
