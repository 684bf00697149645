"""A run store written by both packages, shared by the reader tests
(tests/test_torch_port_registry.py, _report.py, _runs.py).

Six small journaled runs, made from seed 0 on the CPU by each package's
own CLI (in process): the JAX package's under run ids ``j_<name>``, the
port's (``--device cpu``) under ``p_<name>``, all in one ``runs/`` and one
``logs/``, so every reader reads a store that holds both packages' runs:

- ``obs``: Krum with ``--telemetry --margins --numerics --profile-every 1
  --round-stats --cost-report`` (every observatory's events);
- ``plain``: Krum with no observatory, its data streamed from the host
  (``--data-placement host_stream``: the 'stream' event);
- ``faulted``: TrimmedMean with dropout and NaN corruption;
- ``async``: TrimmedMean, ``--aggregation async --async-buffer 6``;
- ``traffic``: Krum under ``--traffic-population 40``;
- ``hier``: Median/Median, ``--aggregation hierarchical --megabatch 4``
  at n = 16 with ``--telemetry`` (the forensics stream).

The store is built once a test session: with pytest-xdist its workers
share one copy under the session's base temporary directory (a file lock
orders them), and it is only read there.  A test that writes (a refresh,
a tag) takes :func:`store_copy`, which copies ``runs/`` into its own
directory; the manifests keep naming the shared event logs, which
nothing writes.
"""

import contextlib
import io
import os
import shutil

from filelock import FileLock

COMMON = ["-s", "SYNTH_MNIST", "-n", "8", "-m", "0.25", "-e", "3", "-c",
          "16", "--synth-train", "200", "--synth-test", "40", "--seed", "0"]
RUNS = {
    "obs": ["-d", "Krum", "--telemetry", "--margins", "--numerics",
            "--profile-every", "1", "--round-stats", "--cost-report"],
    "plain": ["-d", "Krum", "--data-placement", "host_stream"],
    "faulted": ["-d", "TrimmedMean", "--fault-dropout", "0.2",
                "--fault-corrupt", "0.1"],
    "async": ["-d", "TrimmedMean", "--aggregation", "async",
              "--async-buffer", "6"],
    "traffic": ["-d", "Krum", "--traffic-population", "40"],
    "hier": ["-n", "16", "-d", "Median", "--aggregation", "hierarchical",
             "--megabatch", "4", "--tier2-defense", "Median",
             "--telemetry"],
}
PACKAGES = ("j", "p")


def run_ids(pkg=None):
    return [f"{p}_{name}" for p in (PACKAGES if pkg is None else (pkg,))
            for name in RUNS]


def _build(store):
    from attacking_federate_learning_tpu import cli as jax_cli
    from attacking_federate_learning_tpu_torch import cli as port_cli

    for name, flags in RUNS.items():
        for pkg, main, extra in (("j", jax_cli.main, ["--backend", "cpu"]),
                                 ("p", port_cli.main, ["--device", "cpu"])):
            main(COMMON + flags + extra + [
                "--run-id", f"{pkg}_{name}",
                "--log-dir", os.path.join(store, "logs"),
                "--run-dir", os.path.join(store, "runs")])


def shared_store(tmp_path_factory) -> str:
    """The store's directory, built on first use in this session."""
    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    store = os.path.join(str(root), "torch_port_store")
    with FileLock(store + ".lock"):
        if not os.path.exists(os.path.join(store, "DONE")):
            shutil.rmtree(store, ignore_errors=True)
            _build(store)
            open(os.path.join(store, "DONE"), "w").close()
    return store


def capture(fn, argv):
    """A reader's (rc, stdout lines); a SystemExit becomes ("exit",
    code)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            rc = fn(argv)
        except SystemExit as e:
            rc = ("exit", e.code)
    return rc, buf.getvalue().splitlines()


def store_copy(store, dest) -> str:
    """A writable copy of the store's ``runs/`` under ``dest``, without
    the index; returns its path."""
    runs = os.path.join(str(dest), "runs")
    shutil.copytree(os.path.join(store, "runs"), runs)
    # The stamped index names the shared dirs: the copy indexes afresh.
    os.unlink(os.path.join(runs, "index.jsonl"))
    return runs
