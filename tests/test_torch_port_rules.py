"""Rules the port keeps, checked without a card.

- No module of the port, and not ``chip_smoke.py``, imports JAX or the
  JAX package (an AST scan: this interpreter may have imported jax before
  the tests start, so ``sys.modules`` proves nothing).
- Entry points run on the card by default: without CUDA, constructing an
  experiment or running the CLI with no device raises instead of running
  on the CPU.
- A kernel wrapper given a CUDA tensor launches its kernel or raises; it
  never takes the plain version.  With no compiler and no built library,
  it raises.
"""

import ast
import inspect
from pathlib import Path

import pytest
import torch

import attacking_federate_learning_tpu_torch as port
from attacking_federate_learning_tpu_torch import cli
from attacking_federate_learning_tpu_torch import config as C
from attacking_federate_learning_tpu_torch.config import ExperimentConfig
from attacking_federate_learning_tpu_torch.core.engine import (
    FederatedExperiment
)
from attacking_federate_learning_tpu_torch.data.datasets import load_dataset
from attacking_federate_learning_tpu_torch.ops import _build
from attacking_federate_learning_tpu_torch.ops.defense_kernels import (
    krum_scores, masked_median, masked_trimmed_mean, median_of,
    trimmed_mean_of
)
from attacking_federate_learning_tpu_torch.ops.distances import (
    pairwise_distances
)
from attacking_federate_learning_tpu_torch.ops.threefry_bits import (
    threefry_bits
)

ROOT = Path(__file__).resolve().parent.parent
PORT_DIR = Path(port.__file__).resolve().parent
SOURCES = sorted(PORT_DIR.rglob("*.py")) + [ROOT / "chip_smoke.py"]
JAX_PACKAGE = "attacking_federate_learning_tpu"


def forbidden(module: str) -> bool:
    """True for jax and for the JAX package or any of its submodules;
    the port's own name begins with the JAX package's and is allowed."""
    top = module.split(".")[0]
    return top in ("jax", "jaxlib") or top == JAX_PACKAGE


def forbidden_imports(source: str):
    """Every module the source imports (statements, ``__import__`` and
    ``importlib.import_module`` with a literal name) that is forbidden."""
    found = []
    for node in ast.walk(ast.parse(source)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif isinstance(node, ast.Call) and node.args:
            fn = node.func
            fname = (fn.id if isinstance(fn, ast.Name) else
                     fn.attr if isinstance(fn, ast.Attribute) else "")
            arg = node.args[0]
            if (fname in ("__import__", "import_module")
                    and isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)):
                names = [arg.value]
        found += [n for n in names if forbidden(n)]
    return found


def test_the_scan_covers_the_hierarchical_modules():
    for rel in ("ops/federated.py", "core/faults.py", "core/population.py",
                "defenses/kernels.py", "core/engine.py"):
        assert PORT_DIR / rel in SOURCES, rel


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_import(path):
    assert forbidden_imports(path.read_text()) == []


def test_the_scan_sees_every_form_of_import():
    bad = ("import jax\n"
           "import jax.numpy as jnp\n"
           "from jax import lax\n"
           "import attacking_federate_learning_tpu.config\n"
           "from attacking_federate_learning_tpu.data import partition\n"
           "from attacking_federate_learning_tpu import config\n"
           "importlib.import_module('attacking_federate_learning_tpu.ops')\n"
           "__import__('jaxlib')\n")
    assert len(forbidden_imports(bad)) == 8
    ok = ("import attacking_federate_learning_tpu_torch\n"
          "from attacking_federate_learning_tpu_torch.config import C\n"
          "from .ops import _build\n"
          "import jaxtyping\n")
    assert forbidden_imports(ok) == []


def test_the_scan_covers_the_whole_port():
    names = {p.relative_to(PORT_DIR).as_posix() for p in SOURCES[:-1]}
    for module in ("config.py", "cli.py", "core/engine.py",
                   "core/faults.py", "core/population.py",
                   "core/client.py", "data/partition.py",
                   "utils/threefry.py",
                   "ops/_build.py", "ops/distances.py",
                   "ops/defense_kernels.py", "defenses/kernels.py",
                   "defenses/median.py", "attacks/backdoor.py",
                   "attacks/baselines.py", "attacks/minmax.py",
                   "data/triggers.py", "utils/plugins.py",
                   "ops/threefry_bits.py", "defenses/dnc.py",
                   "defenses/geomed.py", "defenses/centeredclip.py",
                   "defenses/fltrust.py", "defenses/normbound.py",
                   "core/async_rounds.py", "protocols/secagg.py",
                   "ops/secagg_masks.py", "utils/costs.py",
                   "utils/profiling.py", "utils/walls.py",
                   "utils/trace_export.py", "utils/registry.py",
                   "report.py", "runs_cli.py", "grid.py", "supervisor.py",
                   "campaigns/__init__.py", "campaigns/__main__.py",
                   "campaigns/cli.py", "campaigns/journal.py",
                   "campaigns/scheduler.py", "campaigns/spec.py"):
        assert module in names


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour on a machine without CUDA")


def test_entry_points_default_to_the_card():
    assert inspect.signature(
        FederatedExperiment.__init__).parameters["device"].default == "cuda"
    assert cli.build_parser().parse_args([]).device == "cuda"


def test_campaigns_grid_and_supervised_children_default_to_the_card(
        tmp_path, monkeypatch):
    from attacking_federate_learning_tpu_torch import grid, supervisor
    from attacking_federate_learning_tpu_torch.campaigns import Campaign
    from attacking_federate_learning_tpu_torch.campaigns import (
        cli as campaign_cli
    )
    from attacking_federate_learning_tpu_torch.campaigns.scheduler import (
        InlineExecutor, SupervisorExecutor
    )

    for fn in (Campaign.__init__, grid.run_grid, InlineExecutor.__init__,
               SupervisorExecutor.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    sup = supervisor.Supervisor(
        supervisor.build_opts(run_id="r", events=str(tmp_path / "e")),
        ["-s", "SYNTH_MNIST", "--log-dir", str(tmp_path)])
    cmd = sup.build_cmd(1)
    assert cmd[2] == "attacking_federate_learning_tpu_torch.cli"
    assert cli.build_parser().parse_args(cmd[3:]).device == "cuda"
    # The campaign CLI's --device defaults to the card as well.
    spec = tmp_path / "spec.json"
    spec.write_text('{"name": "d", "base": {"epochs": 1}}')
    camp_args = []

    class Probe(Campaign):
        def __init__(self, *a, **kw):
            camp_args.append(kw["device"])
            raise SystemExit(0)

    monkeypatch.setattr(
        "attacking_federate_learning_tpu_torch.campaigns.scheduler."
        "Campaign", Probe)
    with pytest.raises(SystemExit):
        campaign_cli.main([str(spec)])
    assert camp_args == ["cuda"]


def test_experiment_without_device_raises_without_cuda():
    _no_cuda()
    cfg = ExperimentConfig(dataset=C.SYNTH_MNIST_HARD, users_count=7,
                           synth_train=100, synth_test=20)
    ds = load_dataset(C.SYNTH_MNIST_HARD, seed=0, synth_train=100,
                      synth_test=20)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FederatedExperiment(cfg, dataset=ds)
    # Asking for the CPU by name runs.
    exp = FederatedExperiment(cfg, dataset=ds, device="cpu")
    assert exp.state.weights.device.type == "cpu"


def test_cli_without_device_raises_without_cuda():
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["-s", C.SYNTH_MNIST_HARD, "-n", "7", "-e", "1",
                  "--synth-train", "100", "--synth-test", "20"])


def test_unknown_device_is_refused():
    cfg = ExperimentConfig(dataset=C.SYNTH_MNIST_HARD, users_count=7,
                           synth_train=100, synth_test=20)
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        FederatedExperiment(cfg, device="meta")


def test_resolving_the_card_makes_its_runs_reproducible(monkeypatch):
    """A CUDA device turns TF32 off and cuDNN onto its deterministic
    convolution algorithms (a default conv backward accumulates with
    atomics: two cifar10_cnn runs of one config parted by 1.5e-5 in five
    rounds on an H100, so a streamed run could not be its device twin
    bit for bit).  The flags are process-wide; the CPU leaves them."""
    from attacking_federate_learning_tpu_torch.core.engine import (
        resolve_device
    )

    flags = (torch.backends.cuda.matmul, "allow_tf32"), (
        torch.backends.cudnn, "allow_tf32"), (torch.backends.cudnn,
                                              "deterministic")
    for mod, name in flags:
        monkeypatch.setattr(mod, name, not (name == "deterministic"))
    assert resolve_device("cpu").type == "cpu"
    assert [getattr(m, n) for m, n in flags] == [True, True, False]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device("cuda").type == "cuda"
    assert [getattr(m, n) for m, n in flags] == [False, False, True]


class _CudaMatrix:
    """Stands in for a (4, 8) float32 CUDA tensor on a machine that
    cannot make one: the wrappers read only these attributes before they
    load their kernel."""

    device = torch.device("cuda", 0)
    dtype = torch.float32
    shape = (4, 8)

    def dim(self):
        return 2

    def is_contiguous(self):
        return True


class _CudaMask:
    """Stands in for the (4,) bool CUDA mask of the masked kernels."""

    device = torch.device("cuda", 0)
    dtype = torch.bool
    shape = (4,)

    def is_contiguous(self):
        return True


_WRAPPERS = {
    "pairwise_distances": lambda G: pairwise_distances(G),
    "krum_scores": lambda G: krum_scores(G, 2),
    "trimmed_mean": lambda G: trimmed_mean_of(G, 1),
    "median": lambda G: median_of(G),
    "masked_trimmed_mean": lambda G: masked_trimmed_mean(G, _CudaMask(), 2),
    "masked_median": lambda G: masked_median(G, _CudaMask()),
}


class _CudaBf16Matrix(_CudaMatrix):
    """The stand-in as a bf16 matrix: the Gram kernels' bf16 route."""

    dtype = torch.bfloat16


_BF16_WRAPPERS = {
    "pairwise_distances[bf16]": lambda G: pairwise_distances(G),
    "krum_scores[bf16]": lambda G: krum_scores(G, 2),
}


@pytest.mark.parametrize("name", sorted(_BF16_WRAPPERS))
def test_bf16_route_raises_for_cuda_without_a_kernel(name, tmp_path,
                                                     monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setenv("NVCC", str(tmp_path / "no-nvcc"))
    before = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="no nvcc found"):
        _BF16_WRAPPERS[name](_CudaBf16Matrix())
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("name", sorted(_BF16_WRAPPERS))
def test_bf16_route_refuses_what_it_does_not_take(name):
    class Strided(_CudaBf16Matrix):
        def is_contiguous(self):
            return False

    with pytest.raises(ValueError, match="contiguous 2-D bfloat16"):
        _BF16_WRAPPERS[name](Strided())
    # The f32 kernels refuse bf16, and the bf16 routes f32.
    with pytest.raises(ValueError, match="contiguous 2-D float32"):
        _build.check_cuda_matrix(_CudaBf16Matrix(), name[:-len("[bf16]")])
    with pytest.raises(ValueError, match="contiguous 2-D bfloat16"):
        _build.check_cuda_matrix(_CudaMatrix(), name)


def test_the_gram_sources_build_both_routes_into_one_library():
    """Each source is one library, keyed by the source and every shared
    header: the f32 route (gram_tile.cuh) and the bf16 route's tensor-core
    stage 1 (gram_mma.cuh) of a Gram kernel share it."""
    for name in ("pairwise_distances", "krum_scores"):
        assert (_build.library_path(name)
                == _build.library_path(f"{name}[bf16]"))
        source = (_build.CSRC / _build.KERNELS[name][0]).read_text()
        assert '#include "gram_tile.cuh"' in source
        assert '#include "gram_mma.cuh"' in source
        assert "uint16_t" in source
    mma = (_build.CSRC / "gram_mma.cuh").read_text()
    assert "template <int WGS, int N, int KS>" in mma
    assert "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16" in mma
    # The f32 header is f32 only again: no element-type template.
    tile = (_build.CSRC / "gram_tile.cuh").read_text()
    assert "template <int KG, int VEC>" in tile
    assert "typename T" not in tile and "uint16_t" not in tile


@pytest.mark.parametrize("name", sorted(_WRAPPERS))
def test_wrapper_raises_for_cuda_without_a_kernel(name, tmp_path,
                                                  monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setenv("NVCC", str(tmp_path / "no-nvcc"))
    before = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="no nvcc found"):
        _WRAPPERS[name](_CudaMatrix())
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("name", sorted(_WRAPPERS))
def test_wrapper_refuses_what_the_kernel_does_not_take(name):
    class Double(_CudaMatrix):
        dtype = torch.float64

    class Strided(_CudaMatrix):
        def is_contiguous(self):
            return False

    for bad in (Double(), Strided()):
        with pytest.raises(ValueError, match="contiguous 2-D float32"):
            _WRAPPERS[name](bad)
    with pytest.raises(ValueError, match="takes a CUDA tensor"):
        _WRAPPERS[name](torch.zeros(4, 8, device="meta"))


class _CudaKeys:
    """Stands in for the (3, 2) int64 CUDA key words of the threefry
    kernel."""

    device = torch.device("cuda", 0)
    dtype = torch.int64
    shape = (3, 2)

    def dim(self):
        return 2

    def is_contiguous(self):
        return True


# The kernels that port no TPU kernel: DnC's sketch bits on the card, and
# secure aggregation's masks (tests/test_torch_port_secagg.py holds their
# wrappers' refusals).
_KEY_WRAPPERS = {"threefry_bits": lambda K: threefry_bits(K, 16)}
_SECAGG_KERNELS = ("secagg_deltas", "secagg_residue", "secagg_unmask_sum")


def test_every_kernel_has_a_source_and_a_counter():
    assert sorted(_build.KERNELS) == sorted(_build.LAUNCHES) == sorted(
        {**_WRAPPERS, **_BF16_WRAPPERS, **_KEY_WRAPPERS,
         **dict.fromkeys(_SECAGG_KERNELS)})
    for name, (source, symbol, _) in _build.KERNELS.items():
        text = (_build.CSRC / source).read_text()
        assert f'extern "C" int {symbol}(' in text
        assert ("Replaces no TPU kernel"
                if name in _KEY_WRAPPERS or name in _SECAGG_KERNELS
                else "Replaces the TPU kernel") in text
    # The library name follows the sources, so an edited kernel rebuilds.
    paths = {_build.library_path(n) for n in _build.KERNELS}
    assert len(paths) == 8 and all(p.parent == _build.BUILD_DIR
                                   for p in paths)


def test_threefry_kernel_raises_for_cuda_without_a_kernel(tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setenv("NVCC", str(tmp_path / "no-nvcc"))
    before = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="no nvcc found"):
        _KEY_WRAPPERS["threefry_bits"](_CudaKeys())
    assert _build.LAUNCHES == before


def test_threefry_kernel_refuses_what_it_does_not_take():
    class Int32Keys(_CudaKeys):
        dtype = torch.int32

    class WideKeys(_CudaKeys):
        shape = (3, 3)

    before = dict(_build.LAUNCHES)
    for bad in (Int32Keys(), WideKeys()):
        with pytest.raises(ValueError, match=r"\(K, 2\) int64 keys"):
            threefry_bits(bad, 16)
    with pytest.raises(ValueError, match="32-bit counter"):
        threefry_bits(_CudaKeys(), 2 ** 32)
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("name", ["masked_trimmed_mean", "masked_median"])
def test_masked_wrappers_refuse_a_bad_mask_or_weights(name):
    """The masked kernels read an (n,) bool mask and (n,) float32 weights
    on the matrix's device; anything else is refused before a launch."""
    call = {"masked_trimmed_mean":
            lambda G, m, w: masked_trimmed_mean(G, m, 2, w),
            "masked_median": lambda G, m, w: masked_median(G, m, w)}[name]

    class FloatMask(_CudaMask):
        dtype = torch.float32

    class ShortMask(_CudaMask):
        shape = (3,)

    class HostMask(_CudaMask):
        device = torch.device("cpu")

    class DoubleWeights(_CudaMask):
        dtype = torch.float64

    before = dict(_build.LAUNCHES)
    for bad in (FloatMask(), ShortMask(), HostMask()):
        with pytest.raises(ValueError, match="bool mask"):
            call(_CudaMatrix(), bad, None)
    with pytest.raises(ValueError, match="float32 weights"):
        call(_CudaMatrix(), _CudaMask(), DoubleWeights())
    assert _build.LAUNCHES == before


# The host engines and host streaming: the port's own copies of the JAX
# package's native/, defenses/host.py and data/stream.py.
HOST_MODULES = ("native/__init__.py", "defenses/host.py", "data/stream.py")


def environment_reads(source: str):
    """Every read of the process environment in the source: os.environ,
    os.getenv, os.environ.get and the like."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Attribute) and node.attr in (
                "environ", "getenv", "environb", "getenvb"):
            found.append(node.attr)
        elif isinstance(node, ast.Name) and node.id in ("environ",
                                                         "getenv"):
            found.append(node.id)
    return found


def test_the_scan_covers_the_host_engines_and_streaming():
    for rel in HOST_MODULES:
        assert PORT_DIR / rel in SOURCES, rel
        assert forbidden_imports((PORT_DIR / rel).read_text()) == []


@pytest.mark.parametrize("rel", HOST_MODULES + ("ops/_build.py",))
def test_no_environment_switch_selects_a_route(rel):
    """No FL_NATIVE or any other variable picks the native library, the
    NumPy plain versions or the device suite: the config alone does."""
    text = (PORT_DIR / rel).read_text()
    assert "FL_NATIVE" not in text
    reads = environment_reads(text)
    # The CUDA compiler's location ($NVCC) is the one variable the build
    # reads, and it selects no route.
    assert reads == (["environ"] if rel == "ops/_build.py" else []), reads
    if rel == "ops/_build.py":
        assert text.count("os.environ.get(") == 1
        assert 'os.environ.get("NVCC")' in text
    cpp = (PORT_DIR / "native" / "bulyan_select.cpp").read_text()
    assert "getenv" not in cpp and "FL_NATIVE" not in cpp


def test_the_scan_sees_an_environment_read():
    assert sorted(environment_reads(
        "import os\nos.environ.get('X')\nos.getenv('Y')\n"
        "from os import environ\nenviron['Z']\n")) == [
            "environ", "environ", "getenv"]


def test_the_g_plus_plus_build_lands_in_build_and_raises_on_failure(
        tmp_path, monkeypatch):
    assert _build.host_library_path("bulyan_select").parent == (
        _build.BUILD_DIR)
    assert _build.BUILD_DIR == PORT_DIR / "_build"
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "GXX", str(tmp_path / "no-g++"))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        _build.load_host_library("bulyan_select")
    monkeypatch.setattr(_build, "GXX", "g++")
    lib = _build.load_host_library("bulyan_select")
    assert lib is _build.load_host_library("bulyan_select")
    built = list((tmp_path / "_build").iterdir())
    assert built == [_build.host_library_path("bulyan_select")]
