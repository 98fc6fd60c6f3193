"""The PyTorch port imports without JAX and without the JAX package.

Every module of ``veles.simd_tpu_torch`` (and ``chip_smoke.py``,
``bench_torch.py``, ``graft_entry_torch.py``, the port's tools and
examples) is imported in a fresh
interpreter where ``import jax`` fails; afterwards no
``veles.simd_tpu`` module may be loaded.  Every port module of the op
library exports each public name of its JAX twin.
"""

import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "veles" / "simd_tpu_torch"
# the port's twins of the JAX examples (examples/<name>_torch.py)
EXAMPLES = ("matched_filter", "sensor_pipeline", "image_filter",
            "wavelet_denoise", "wavelet_multires", "spectral_zoom",
            "kaiser_design", "sharded_longsignal")


def _port_modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_port_modules_listed():
    mods = _port_modules()
    for name in ("veles.simd_tpu_torch.ops.spectral",
                 "veles.simd_tpu_torch.ops.batched",
                 "veles.simd_tpu_torch.ops.waveforms",
                 "veles.simd_tpu_torch.ops.convolve",
                 "veles.simd_tpu_torch.ops.convolve2d",
                 "veles.simd_tpu_torch.ops.wavelet",
                 "veles.simd_tpu_torch.ops.wavelet_coeffs",
                 "veles.simd_tpu_torch.ops.correlate",
                 "veles.simd_tpu_torch.ops.cuda_kernels",
                 "veles.simd_tpu_torch.ops.matrix",
                 "veles.simd_tpu_torch.ops.arithmetic",
                 "veles.simd_tpu_torch.ops.mathfun",
                 "veles.simd_tpu_torch.ops.normalize",
                 "veles.simd_tpu_torch.ops.detect_peaks",
                 "veles.simd_tpu_torch.ops.filters",
                 "veles.simd_tpu_torch.ops.iir",
                 "veles.simd_tpu_torch.ops.resample",
                 "veles.simd_tpu_torch.ops.segments",
                 "veles.simd_tpu_torch.runtime.precision",
                 "veles.simd_tpu_torch.runtime.routing",
                 "veles.simd_tpu_torch.runtime.faults",
                 "veles.simd_tpu_torch.runtime.breaker",
                 "veles.simd_tpu_torch.obs",
                 "veles.simd_tpu_torch.obs.flightrec",
                 "veles.simd_tpu_torch.obs.atomic",
                 "veles.simd_tpu_torch.obs.export",
                 "veles.simd_tpu_torch.obs.resources",
                 "veles.simd_tpu_torch.obs.compile",
                 "veles.simd_tpu_torch.obs.journal",
                 "veles.simd_tpu_torch.utils.profiler",
                 "veles.simd_tpu_torch.utils.platform",
                 "veles.simd_tpu_torch.pipeline",
                 "veles.simd_tpu_torch.pipeline.stages",
                 "veles.simd_tpu_torch.pipeline.compiler",
                 "veles.simd_tpu_torch.obs.requests",
                 "veles.simd_tpu_torch.obs.http",
                 "veles.simd_tpu_torch.serve",
                 "veles.simd_tpu_torch.serve.admission",
                 "veles.simd_tpu_torch.serve.health",
                 "veles.simd_tpu_torch.serve.batcher",
                 "veles.simd_tpu_torch.serve.server",
                 "veles.simd_tpu_torch.obs.timeseries",
                 "veles.simd_tpu_torch.obs.incidents",
                 "veles.simd_tpu_torch.serve.rpc",
                 "veles.simd_tpu_torch.serve.cluster",
                 "veles.simd_tpu_torch.serve.scaler",
                 "veles.simd_tpu_torch.parallel",
                 "veles.simd_tpu_torch.parallel.mesh",
                 "veles.simd_tpu_torch.parallel.ops",
                 "veles.simd_tpu_torch.parallel.fourier",
                 "veles.simd_tpu_torch.parallel.distributed",
                 "veles.simd_tpu_torch.runtime.artifacts",
                 "veles.simd_tpu_torch.cshim",
                 "veles.simd_tpu_torch.cabi"):
        assert name in mods


def test_port_imports_without_jax():
    # the C shim computes on the card unless VELES_SIMD_PLATFORM=cpu,
    # and its import fails where no card answers: the child sets it
    code = f"""
import importlib, os, runpy, sys
os.environ["VELES_SIMD_PLATFORM"] = "cpu"
sys.modules["jax"] = None
sys.path.insert(0, {str(REPO)!r})
for name in {_port_modules()!r}:
    importlib.import_module(name)
runpy.run_path({str(REPO / "chip_smoke.py")!r}, run_name="chip_smoke")
runpy.run_path({str(REPO / "graft_entry_torch.py")!r},
               run_name="graft_entry_torch")
bad = sorted(m for m in sys.modules
             if m == "veles.simd_tpu" or m.startswith("veles.simd_tpu."))
assert not bad, bad
assert sys.modules["jax"] is None
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def _jax_tools():
    """Module names of the JAX package's tools (``tools/*.py`` with no
    ``torch`` in the name)."""
    return sorted(p.stem for p in (REPO / "tools").glob("*.py")
                  if "torch" not in p.stem)


# the developer gate's tools keep their own copy of what they need of
# their JAX twins; an older port tool may share a JAX tool module that
# loads nothing of JAX (``gen_docs_torch.py`` reads ``gen_docs.MODULES``)
OWN_COPY_TOOLS = ("lint_torch.py", "linecov_torch.py", "run_tests_torch.py",
                  "gen_wavelet_tables_torch.py")


@pytest.mark.parametrize("tool", ["autotune_pack_torch.py",
                                  "tune_overlap_save_torch.py",
                                  "time_torch_autotune_off.py",
                                  "time_torch_obs_off.py",
                                  "time_torch_profiler_sessions.py",
                                  "time_torch_bench_headline.py",
                                  "cold_start_torch.py",
                                  "warm_pack_torch.py",
                                  "loadgen_torch.py",
                                  "tpu_smoke_torch.py",
                                  "benchmark_suite_torch.py",
                                  "obs_query_torch.py",
                                  "chaos_torch.py",
                                  "obs_report_torch.py",
                                  "obs_dash_torch.py",
                                  "bench_multichip_torch.py",
                                  "tune_conv2d_torch.py",
                                  "profile_overlap_save_torch.py",
                                  "check_wavelet_parity_torch.py",
                                  "time_torch_spectral_obs.py",
                                  "time_torch_ops_obs.py",
                                  "time_torch_spans.py",
                                  "gen_docs_torch.py",
                                  "lint_torch.py",
                                  "linecov_torch.py",
                                  "run_tests_torch.py",
                                  "gen_wavelet_tables_torch.py"])
def test_port_tools_import_without_jax(tool):
    banned = _jax_tools() if tool in OWN_COPY_TOOLS else []
    code = f"""
import runpy, sys
sys.modules["jax"] = None
sys.path.insert(0, {str(REPO)!r})
ns = runpy.run_path({str(REPO / "tools" / tool)!r}, run_name="tool")
assert callable(ns["main"])
bad = sorted(m for m in sys.modules
             if m == "veles.simd_tpu" or m.startswith("veles.simd_tpu."))
assert not bad, bad
# nor, for the developer gate's tools, a JAX tool module
jax_tools = sorted(m for m in {banned!r} if m in sys.modules)
assert not jax_tools, jax_tools
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("tool", ["autotune_pack_torch.py",
                                  "tune_overlap_save_torch.py",
                                  "time_torch_autotune_off.py",
                                  "time_torch_obs_off.py",
                                  "time_torch_profiler_sessions.py",
                                  "time_torch_bench_headline.py"])
def test_port_tools_refuse_to_run_without_a_card(tool):
    # the CPU has no card: the tools exit 2 before measuring anything
    code = f"""
import runpy, sys
sys.modules["jax"] = None
sys.argv = ["{tool}", "--quick"]
sys.path.insert(0, {str(REPO)!r})
import torch
torch.cuda.is_available = lambda: False
ns = runpy.run_path({str(REPO / "tools" / tool)!r}, run_name="tool")
sys.exit(ns["main"]())
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 2, out.stderr
    assert "no CUDA card" in out.stderr


@pytest.mark.parametrize("script,argv", [
    ("bench_torch.py", []),
    ("bench_torch.py", ["--check"]),
    ("tools/tpu_smoke_torch.py", []),
    ("tools/loadgen_torch.py", ["--smoke"]),
    ("tools/warm_pack_torch.py", []),
    ("tools/cold_start_torch.py", []),
    ("tools/benchmark_suite_torch.py", []),
    ("tools/chaos_torch.py", ["--smoke"]),
    ("tools/bench_multichip_torch.py", ["--quick"]),
    ("tools/tune_conv2d_torch.py", ["--quick"]),
    ("tools/profile_overlap_save_torch.py", []),
    ("graft_entry_torch.py", []),
] + [(f"examples/{name}_torch.py", []) for name in EXAMPLES])
def test_measuring_tools_refuse_to_run_without_a_card(script, argv):
    # bench_torch.py and the tools it drives probe for a card (a
    # subprocess, require_reachable_device) and exit 2 without one,
    # with JAX blocked, before measuring anything
    code = f"""
import runpy, sys
sys.modules["jax"] = None
sys.argv = [{script!r}] + {argv!r}
sys.path.insert(0, {str(REPO)!r})
ns = runpy.run_path({str(REPO / script)!r}, run_name="tool")
sys.exit(ns["main"]())
"""
    env = dict(os.environ, VELES_SIMD_DEVICE_WAIT="0")
    env.pop("VELES_SIMD_PLATFORM", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 2, (out.stdout[-2000:], out.stderr[-2000:])
    assert "no CUDA card" in out.stderr
    assert "TPU-CHECK" not in out.stderr and not out.stdout.strip()


@pytest.mark.parametrize("script", ["tools/warm_pack_torch.py",
                                    "tools/cold_start_torch.py"])
def test_kernel_library_tools_refuse_the_cpu(script):
    # the warm pack is the CUDA kernel library: VELES_SIMD_PLATFORM=cpu
    # has none to pack or to start cold from
    env = dict(os.environ, VELES_SIMD_PLATFORM="cpu")
    out = subprocess.run([sys.executable, str(REPO / script)], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 2, out.stderr[-2000:]
    assert "CUDA kernel library" in out.stderr


@pytest.mark.parametrize("name", EXAMPLES)
def test_port_examples_import_without_jax(name):
    # each example's steps, run() and main() load nothing of JAX
    code = f"""
import runpy, sys
sys.modules["jax"] = None
sys.path.insert(0, {str(REPO)!r})
ns = runpy.run_path({str(REPO / "examples" / (name + "_torch.py"))!r},
                    run_name="example")
assert callable(ns["main"]) and callable(ns["run"])
assert isinstance(ns["SIZES"], dict)
bad = sorted(m for m in sys.modules
             if m == "veles.simd_tpu" or m.startswith("veles.simd_tpu."))
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("script,argv,expect", [
    ("tools/check_wavelet_parity_torch.py", ["--orders", "4"], "[ok]"),
    ("tools/gen_docs_torch.py", None, "# `veles.simd_tpu_torch.cshim`"),
])
def test_cpu_tools_run_without_a_card(script, argv, expect):
    # the stated exceptions: the symlet check is host arithmetic and
    # the API pages import the port on the CPU, so neither exits 2
    # without a card or VELES_SIMD_PLATFORM (the pages are rendered,
    # not written, here)
    call = ("sys.exit(ns['main']())" if argv is not None else
            "print(ns['render_module']('veles.simd_tpu_torch.cshim'))")
    code = f"""
import runpy, sys
sys.modules["jax"] = None
sys.argv = [{script!r}] + {argv or []!r}
sys.path.insert(0, {str(REPO)!r})
import torch
torch.cuda.is_available = lambda: False
ns = runpy.run_path({str(REPO / script)!r}, run_name="tool")
{call}
"""
    env = dict(os.environ, VELES_SIMD_DEVICE_WAIT="0")
    env.pop("VELES_SIMD_PLATFORM", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert expect in out.stdout


def test_bench_torch_imports_without_jax():
    code = f"""
import runpy, sys
sys.modules["jax"] = None
sys.path.insert(0, {str(REPO)!r})
ns = runpy.run_path({str(REPO / "bench_torch.py")!r}, run_name="bench")
assert callable(ns["main"]) and callable(ns["bench_convolve_1m"])
import tools.tpu_smoke_torch, tools.loadgen_torch, tools.cold_start_torch
bad = sorted(m for m in sys.modules
             if m == "veles.simd_tpu" or m.startswith("veles.simd_tpu."))
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_graft_entry_torch_imports_without_jax():
    # the flagship step's twin defines the JAX file's functions and
    # its own weight moves, and loads neither JAX, the JAX package nor
    # __graft_entry__
    code = f"""
import runpy, sys
sys.modules["jax"] = None
sys.path.insert(0, {str(REPO)!r})
ns = runpy.run_path({str(REPO / "graft_entry_torch.py")!r},
                    run_name="graft_entry_torch")
for name in ("_pipeline", "entry", "params_from_jax", "params_to_numpy",
             "loss_fn", "train_step", "_factor_axes",
             "sharded_train_step", "dryrun_multichip", "_dryrun_body",
             "main"):
    assert callable(ns[name]), name
bad = sorted(m for m in sys.modules
             if m == "veles.simd_tpu" or m.startswith("veles.simd_tpu.")
             or m == "__graft_entry__")
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_benchmark_all_covers_the_jax_all_with_jax_blocked():
    # utils.benchmark holds every generic name of the JAX module's
    # __all__; only the TPU-rate names have no port
    not_applicable = {
        "mxu_peak_tflops", "mxu_f32_bound_tflops", "mxu_int8_peak_tops",
        "MXU_PEAK_TFLOPS_BF16", "MXU_PEAK_TOPS_INT8", "MXU_F32_PASSES",
        "hbm_bw_gbps", "HBM_BW_GBPS", "ici_bw_gbps", "ICI_BW_GBPS",
        "xla_fft_eff_gflops", "XLA_FFT_EFF_GFLOPS", "a2a_ici_bytes"}
    code = f"""
import json, sys
sys.modules["jax"] = None
sys.path.insert(0, {str(REPO)!r})
from veles.simd_tpu_torch.utils import benchmark
missing = [n for n in benchmark.__all__ if not hasattr(benchmark, n)]
assert not missing, missing
print(json.dumps(benchmark.__all__))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    port_all = set(json.loads(out.stdout.strip().splitlines()[-1]))
    ref = importlib.import_module("veles.simd_tpu.utils.benchmark")
    assert not_applicable <= set(ref.__all__)
    assert not port_all & not_applicable
    assert set(ref.__all__) - not_applicable <= port_all, \
        sorted(set(ref.__all__) - not_applicable - port_all)


def _ops_with_jax_twins():
    ops = PKG / "ops"
    return sorted(p.stem for p in ops.glob("*.py")
                  if p.stem != "__init__"
                  and (REPO / "veles" / "simd_tpu" / "ops"
                       / p.name).exists())


def test_op_modules_are_listed_in_pairs():
    names = _ops_with_jax_twins()
    assert {"iir", "resample", "batched", "spectral",
            "convolve"} <= set(names)


@pytest.mark.parametrize("name", ["runtime.faults", "runtime.breaker",
                                  "obs.flightrec", "obs.atomic",
                                  "obs.export", "ops.segments",
                                  "obs.resources", "obs.compile",
                                  "obs.journal", "obs.spans",
                                  "utils.profiler", "utils",
                                  "pipeline", "pipeline.stages",
                                  "pipeline.compiler", "obs.requests",
                                  "obs.http", "serve.server",
                                  "serve.admission", "serve.health",
                                  "serve.batcher", "obs.timeseries",
                                  "obs.incidents", "serve.rpc",
                                  "serve.cluster", "serve.scaler",
                                  "obs", "serve", "parallel",
                                  "parallel.mesh", "parallel.ops",
                                  "parallel.fourier",
                                  "parallel.distributed",
                                  "runtime.artifacts", "runtime"])
def test_runtime_and_obs_copies_keep_the_jax_all(name):
    # the fault policy, the breakers, the flight recorder, its writer
    # and exporters, the segment packing, obs's standalone half, the
    # profiler, the utils package, the pipeline compiler, the request
    # axis, the scrape endpoint, serve's core and the fleet (timeseries,
    # incidents, rpc, cluster, scaler), the sharded families, and the
    # obs, serve and parallel packages themselves, mirror their JAX
    # modules' public surface exactly
    port = importlib.import_module(f"veles.simd_tpu_torch.{name}")
    ref = importlib.import_module(f"veles.simd_tpu.{name}")
    assert port.__all__ == ref.__all__
    for public in ref.__all__:
        assert hasattr(port, public), public


def test_parallel_all_is_the_jax_all_with_jax_blocked():
    code = f"""
import json, sys
sys.modules["jax"] = None
sys.path.insert(0, {str(REPO)!r})
from veles.simd_tpu_torch import parallel
bad = sorted(m for m in sys.modules
             if m == "veles.simd_tpu" or m.startswith("veles.simd_tpu."))
assert not bad, bad
print(json.dumps(parallel.__all__))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    ref = importlib.import_module("veles.simd_tpu.parallel")
    port_all = json.loads(out.stdout.strip().splitlines()[-1])
    assert port_all == ref.__all__
    assert len(port_all) == 35 and "distributed" in port_all


def test_artifacts_all_is_the_jax_all_with_jax_blocked():
    code = f"""
import json, sys
sys.modules["jax"] = None
sys.path.insert(0, {str(REPO)!r})
from veles.simd_tpu_torch.runtime import artifacts
bad = sorted(m for m in sys.modules
             if m == "veles.simd_tpu" or m.startswith("veles.simd_tpu."))
assert not bad, bad
print(json.dumps(artifacts.__all__))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    ref = importlib.import_module("veles.simd_tpu.runtime.artifacts")
    port_all = json.loads(out.stdout.strip().splitlines()[-1])
    assert port_all == ref.__all__ and len(port_all) == 20


def test_cshim_imports_on_the_cpu_without_jax():
    # VELES_SIMD_PLATFORM=cpu: the C shim computes on the CPU and
    # loads nothing of the JAX package; without it and without a card
    # its import raises (the C bridge's init then returns -1)
    code = f"""
import json, os, sys
sys.modules["jax"] = None
sys.path.insert(0, {str(REPO)!r})
from veles.simd_tpu_torch import cshim
from veles.simd_tpu_torch.utils.config import get_config
bad = sorted(m for m in sys.modules
             if m == "veles.simd_tpu" or m.startswith("veles.simd_tpu."))
print(json.dumps({{"bad": bad, "device": get_config().device,
                  "backend": cshim.backend_description()}}))
"""
    env = dict(os.environ, VELES_SIMD_PLATFORM="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"bad": [], "device": "cpu", "backend": "torch:cpu"}


@pytest.mark.parametrize("name", _ops_with_jax_twins())
def test_port_all_covers_the_jax_all(name):
    port = importlib.import_module(f"veles.simd_tpu_torch.ops.{name}")
    ref = importlib.import_module(f"veles.simd_tpu.ops.{name}")
    missing = sorted(set(ref.__all__) - set(port.__all__))
    assert not missing, missing
    for public in ref.__all__:
        assert hasattr(port, public), public


def test_replica_child_runs_without_jax():
    # a subprocess replica's body (serve/cluster.py _replica_main) on
    # the CPU with jax blocked: it reports its port, drains when stdin
    # closes, exits 0, and loaded nothing of the JAX package
    code = f"""
import json, sys
sys.modules["jax"] = None
sys.path.insert(0, {str(REPO)!r})
from veles.simd_tpu_torch.serve.cluster import _replica_main
rc = _replica_main(["--device", "cpu", "--obs-port", "0",
                    "--name", "r9", "--workers", "1"])
bad = sorted(m for m in sys.modules
             if m == "veles.simd_tpu" or m.startswith("veles.simd_tpu."))
print(json.dumps({{"rc": rc, "bad": bad}}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         input="", capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    lines = [json.loads(line) for line in out.stdout.splitlines()]
    assert lines[0]["port"] > 0 and lines[0]["device"] == "cpu"
    assert lines[-1] == {"rc": 0, "bad": []}
