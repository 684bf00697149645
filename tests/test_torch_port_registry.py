"""The port's run registry (utils/registry.py, both halves) against the
JAX package's, over a store that holds both packages' runs
(tests/_torch_port_stores.py) and over small stores made here.

- ``refresh`` indexes both packages' runs, and the port's index is the
  JAX registry's entry for entry; the summary, the incremental reuse,
  ``stale_run_ids``, ``entries`` with filters, ``resolve`` (id, prefix,
  tag, its errors), ``tag`` and ``load_config`` agree;
- the bench and progress sidecars (made in the test's directory) index
  alike;
- the legacy auto-checkpoint migration moves what the JAX registry moves,
  once, and a manifest naming anything else is never rewritten;
- torn manifests, journals and index lines are counted, never fatal.
"""

import json
import os
import time

import pytest

from attacking_federate_learning_tpu.utils.registry import (
    RunRegistry as JRegistry
)
from attacking_federate_learning_tpu_torch.utils.registry import RunRegistry

from _torch_port_stores import run_ids, shared_store, store_copy


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return shared_store(tmp_path_factory)


def _pair(runs):
    return RunRegistry(runs), JRegistry(runs)


def test_refresh_indexes_both_packages_alike(store, tmp_path):
    a = store_copy(store, tmp_path / "a")
    b = store_copy(store, tmp_path / "b")
    got, want = RunRegistry(a).refresh(), JRegistry(b).refresh()
    assert got == want
    assert got["entries"] == len(run_ids()) and got["built"] == got[
        "entries"]
    ents_p, ents_j = RunRegistry(a).entries(), JRegistry(b).entries()
    assert [e["run_id"] for e in ents_p] == sorted(run_ids())
    strip = ("dir", "sig")      # each copy's own directory and mtimes
    assert ([{k: v for k, v in e.items() if k not in strip}
             for e in ents_p]
            == [{k: v for k, v in e.items() if k not in strip}
                for e in ents_j])
    for e in ents_p:
        assert e["status"] == "done" and e["rounds_committed"] == 3
        assert e["source"] == "run"


def test_one_index_read_by_both_registries(store, tmp_path):
    runs = store_copy(store, tmp_path)
    port, jax_reg = _pair(runs)
    port.refresh()
    assert port.entries() == jax_reg.entries()
    # Refreshing in either order reuses every entry: same signatures.
    s = jax_reg.refresh()
    assert s["built"] == 0 and s["reused"] == len(run_ids())
    assert port.refresh() == jax_reg.refresh()


@pytest.mark.parametrize("pkg", ["j", "p"])
def test_entries_carry_each_kind_of_run(store, tmp_path, pkg):
    port = RunRegistry(store_copy(store, tmp_path))
    port.refresh()
    ents = {e["run_id"]: e for e in port.entries(["seed=0"])}
    obs = ents[f"{pkg}_obs"]
    for kind in ("defense", "margin", "numerics", "wall", "stage_cost",
                 "round", "eval", "registry"):
        assert obs["event_kinds"].get(kind, 0) > 0, kind
    assert ents[f"{pkg}_faulted"]["fault_rounds"] == 3
    assert ents[f"{pkg}_async"]["event_kinds"]["async"] == 3
    assert ents[f"{pkg}_traffic"]["event_kinds"]["traffic"] == 3
    assert ents[f"{pkg}_hier"]["event_kinds"]["shard_selection"] == 3
    assert [e["run_id"] for e in port.entries(["defense=TrimmedMean"])
            if e["run_id"].startswith(pkg)] == [f"{pkg}_async",
                                                f"{pkg}_faulted"]


def test_refresh_is_incremental(store, tmp_path):
    runs = store_copy(store, tmp_path)
    port, jax_reg = _pair(runs)
    port.refresh()
    first = port.entries()
    s2 = port.refresh()
    assert s2 == {"entries": len(first), "built": 0, "reused": len(first),
                  "dropped": 0, "migrated": 0}
    assert port.entries() == first
    # A moved manifest rebuilds exactly its run, in both registries.
    man = os.path.join(runs, "p_plain", "manifest.json")
    with open(man) as f:
        blob = json.load(f)
    blob["note"] = "moved"
    with open(man, "w") as f:
        json.dump(blob, f)
    assert port.stale_run_ids() == jax_reg.stale_run_ids() == ["p_plain"]
    s3 = port.refresh()
    assert s3["built"] == 1 and s3["reused"] == len(first) - 1
    assert port.stale_run_ids() == jax_reg.stale_run_ids() == []


def test_stale_run_ids_without_an_index(store, tmp_path):
    port, jax_reg = _pair(store_copy(store, tmp_path))
    assert port.stale_run_ids() == jax_reg.stale_run_ids()
    assert sorted(port.stale_run_ids()) == sorted(run_ids())


def test_resolve_tag_filters_and_errors(store, tmp_path):
    runs = store_copy(store, tmp_path)
    port, jax_reg = _pair(runs)
    port.refresh()
    assert port.resolve("p_hier") == jax_reg.resolve("p_hier")
    assert port.resolve("j_tra")["run_id"] == "j_traffic"
    for query, filters in (("p_", ()), ("nothing", ()),
                           ("j_obs", ("defense=Median",))):
        with pytest.raises(ValueError) as got:
            port.resolve(query, filters)
        with pytest.raises(ValueError) as want:
            jax_reg.resolve(query, filters)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="key=value"):
        port.entries(["defense"])
    port.tag("j_plain", "golden")
    assert jax_reg.resolve("golden")["run_id"] == "j_plain"
    port.refresh()                       # the tag survives a rescan
    assert port.resolve("golden") == jax_reg.resolve("golden")
    with open(os.path.join(runs, "j_plain", "manifest.json")) as f:
        assert json.load(f)["tag"] == "golden"


def test_load_config_reads_either_package_s_config(store, tmp_path):
    port, jax_reg = _pair(store_copy(store, tmp_path))
    port.refresh()
    for rid in run_ids():
        e = port.resolve(rid)
        cfg = port.load_config(e)
        assert cfg == jax_reg.load_config(e)
        assert cfg["defense"] == e["defense"] and cfg["seed"] == 0
    # The JAX config has the two fields the port's lacks.
    assert {"mesh_shape", "backend"} <= set(
        port.load_config(port.resolve("j_obs")))
    assert not {"mesh_shape", "backend"} & set(
        port.load_config(port.resolve("p_obs")))
    assert port.load_config({"source": "bench"}) is None


def test_bench_and_progress_sidecars(tmp_path):
    runs = str(tmp_path / "runs")
    bench = tmp_path / "BENCH_x1.json"
    bench.write_text(json.dumps({"parsed": {
        "metric": "rounds_per_s", "value": 3.5, "unit": "r/s",
        "valid": True, "run_ids": ["a"]}}))
    (tmp_path / "BENCH_torn.json").write_text('{"parsed": {"met')
    prog = tmp_path / "PROGRESS.jsonl"
    prog.write_text(json.dumps({"step": 1}) + "\n"
                    + json.dumps({"step": 2}) + "\n" + '{"step"')
    kw = dict(bench=[str(tmp_path / "BENCH_*.json")],
              progress=[str(prog)])
    got = RunRegistry(runs).refresh(**kw)
    want_dir = str(tmp_path / "jruns")
    want = JRegistry(want_dir).refresh(**kw)
    assert got == want == {"entries": 3, "built": 3, "reused": 0,
                           "dropped": 0, "migrated": 0}
    assert RunRegistry(runs).entries() == JRegistry(want_dir).entries()
    ents = {e["run_id"]: e for e in RunRegistry(runs).entries()}
    assert ents["bench:BENCH_x1"]["value"] == 3.5
    assert ents["bench:BENCH_torn"]["problems"] == [
        "bench JSON missing or torn"]
    p = ents["progress:PROGRESS.jsonl"]
    assert p["lines"] == 2 and p["torn_lines"] == 1
    assert p["last"] == {"step": 2}
    assert RunRegistry(runs).refresh(**kw)["reused"] == 3


def _legacy_store(root):
    runs = root / "runs"
    legacy, owned = runs / "SYNTH_MNIST", runs / "legacy_run"
    os.makedirs(legacy)
    os.makedirs(owned)
    ck = legacy / "checkpoint-auto-00000004.npz"
    ck.write_bytes(b"npz-bytes")
    (legacy / "checkpoint-auto-00000004.json").write_text("{}")
    with open(owned / "manifest.json", "w") as f:
        json.dump({"run_id": "legacy_run", "status": "preempted",
                   "checkpoint": str(ck)}, f)
    # A run whose manifest names its own checkpoint, and one naming the
    # shared best-accuracy save: neither is touched.
    for rid, name in (("own_run", None), ("best_run", "checkpoint.npz")):
        d = runs / rid
        os.makedirs(d)
        path = (d / "checkpoint-auto-00000002.npz" if name is None
                else legacy / name)
        path.write_bytes(b"x")
        with open(d / "manifest.json", "w") as f:
            json.dump({"run_id": rid, "status": "done",
                       "checkpoint": str(path)}, f)
    return runs, ck


def test_legacy_migration_moves_what_jax_moves_once(tmp_path):
    got_runs, ck = _legacy_store(tmp_path / "p")
    want_runs, _ = _legacy_store(tmp_path / "j")
    untouched = {rid: os.path.getmtime(got_runs / rid / "manifest.json")
                 for rid in ("own_run", "best_run")}
    time.sleep(0.01)
    got = RunRegistry(str(got_runs)).refresh()
    want = JRegistry(str(want_runs)).refresh()
    assert got == want and got["migrated"] == 1
    moved = got_runs / "legacy_run" / "checkpoint-auto-00000004.npz"
    assert moved.exists() and not ck.exists()
    assert (got_runs / "legacy_run" / "checkpoint-auto-00000004.json"
            ).exists()
    with open(got_runs / "legacy_run" / "manifest.json") as f:
        assert json.load(f)["checkpoint"] == str(moved)
    for rid, mtime in untouched.items():
        assert os.path.getmtime(got_runs / rid / "manifest.json") == mtime
    assert RunRegistry(str(got_runs)).refresh()["migrated"] == 0
    assert RunRegistry(str(got_runs)).resolve("legacy_run")[
        "migrated_checkpoint"] == str(moved)
    # migrate=False: the registry rewrites no manifest.
    runs2, ck2 = _legacy_store(tmp_path / "n")
    assert RunRegistry(str(runs2)).refresh(migrate=False)["migrated"] == 0
    assert ck2.exists()


def test_torn_artifacts_tolerated(tmp_path):
    d = tmp_path / "runs" / "torn_run"
    os.makedirs(d)
    with open(d / "journal.jsonl", "w") as f:
        f.write(json.dumps({"kind": "rounds", "start": 0, "end": 4}) + "\n")
        f.write('{"kind": "rounds", "start": 5, "e')
    with open(d / "manifest.json", "w") as f:
        f.write('{"run_id": "torn_run", "status"')
    reg = RunRegistry(str(tmp_path / "runs"))
    reg.refresh()
    e = reg.resolve("torn_run")
    assert e == JRegistry(str(tmp_path / "runs")).resolve("torn_run")
    assert e["journal_high"] == 4 and e["torn_lines"] == 1
    assert e["problems"] == ["manifest missing or torn"]
    with open(reg.index_path, "a") as f:
        f.write('{"run_id": "half')
    assert reg.resolve("torn_run")["journal_high"] == 4

