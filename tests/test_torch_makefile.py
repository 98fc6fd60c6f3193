"""The Makefile's ``-torch`` twins and the port's card session scripts.

``make -n <t>-torch`` names an existing port script (a
``tools/*_torch.py``, ``bench_torch.py``, ``chip_smoke.py``, or the
port's test files) with flags that script accepts and the JAX target's
flags and environment; every Makefile target that drives a JAX tool
has a twin or is listed here as not applicable, with its reason; and
``tools/hw_session_torch.sh`` / ``watch_device_torch.sh`` run the
steps they name, each under ``timeout -k``.
"""

import os
import re
import shlex
import shutil
import subprocess
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
MAKEFILE = (REPO / "Makefile").read_text()

pytestmark = pytest.mark.skipif(shutil.which("make") is None,
                                reason="no make on this machine")

# JAX-side targets with no -torch twin, and why
NOT_APPLICABLE = {
    "bench-regress": "the JAX bench's history gate; the port's "
                     "benchmark has no history yet",
    "cshim": "csrc's own build; the port builds its C library at first "
             "use (veles/simd_tpu_torch/cabi)",
    "install": "one package installs both",
    "install-hooks": "one hook for the repo",
}
# a JAX target whose twin has another name
RENAMED = {"cshim-check": "cabi-check-torch"}


def _targets():
    return re.findall(r"^([a-z][a-z0-9-]*):(?!=)", MAKEFILE, re.M)


def _dry_run(target, **env):
    out = subprocess.run(["make", "-s", "-n", target], cwd=REPO,
                         capture_output=True, text=True, timeout=60,
                         env={**os.environ, **env})
    assert out.returncode == 0, out.stderr
    # join the recipe's continued lines into one command each
    return out.stdout.replace("\\\n", " ")


def _commands(target):
    cmds = []
    for line in _dry_run(target).splitlines():
        if line.strip():
            cmds.append(shlex.split(line))
    return cmds


def _script_and_flags(argv):
    """The script a command runs and the flags it passes, past the
    environment assignments and the interpreter."""
    words = [w for w in argv if not re.fullmatch(r"[A-Z_]+=.*", w)]
    assert words[0] in ("python", "python3", "$(PYTHON)"), argv
    words = words[1:]
    if words[:2] == ["-m", "pytest"]:
        return "pytest", words[2:]
    if words[0] == "-c":
        return "-c", words[1:]
    return words[0], words[1:]


def _twin_targets():
    return sorted(t for t in _targets() if t.endswith("-torch"))


def _jax_targets():
    """Targets whose recipe drives a JAX tool, the JAX package's tests
    or csrc's build."""
    out = []
    for t in _targets():
        if t.endswith("-torch") or t in ("chip-smoke", "all", "clean"):
            continue
        recipe = _dry_run(t)
        tools = re.findall(r"tools/([a-z_0-9]+)\.py", recipe)
        if any(not name.endswith("_torch") for name in tools) or \
                "bench.py" in recipe or "-C csrc" in recipe or \
                "-m pytest tests/ " in recipe or \
                "pip install" in recipe or "hooks" in recipe:
            out.append(t)
    return out


def test_the_twins_are_the_ones_asked_for():
    want = {"tests", "tests-quick", "benchmarks", "bench",
            "bench-multichip", "bench-serve", "bench-goodput",
            "bench-rpc", "serve-smoke", "chaos-smoke", "chaos-replicas",
            "chaos-replicas-rpc", "chaos-scale", "wavelet-tables", "lint",
            "docs", "obs-report", "obs-dash", "obs-query", "autotune-pack",
            "warm-pack", "cold-start"}
    twins = set(_twin_targets())
    assert {f"{t}-torch" for t in want} | {"cabi-check-torch"} == twins
    assert "chip-smoke" in _targets()


@pytest.mark.parametrize("target", sorted(
    {"tests", "tests-quick", "benchmarks", "bench", "bench-multichip",
     "bench-serve", "bench-goodput", "bench-rpc", "serve-smoke",
     "chaos-smoke", "chaos-replicas", "chaos-replicas-rpc", "chaos-scale",
     "wavelet-tables", "lint", "docs", "obs-report", "obs-dash",
     "obs-query", "autotune-pack", "warm-pack", "cold-start",
     "cshim-check", "bench-regress", "cshim", "install",
     "install-hooks"}))
def test_every_jax_target_has_a_twin_or_a_reason(target):
    assert target in _jax_targets()
    twin = RENAMED.get(target, f"{target}-torch")
    assert twin in _targets() or target in NOT_APPLICABLE, target
    assert not (twin in _targets() and target in NOT_APPLICABLE)


def test_no_jax_target_is_left_out():
    listed = set(NOT_APPLICABLE) | set(RENAMED)
    for target in _jax_targets():
        twin = RENAMED.get(target, f"{target}-torch")
        assert twin in _targets() or target in listed, target


@pytest.mark.parametrize("target", _twin_targets() + ["chip-smoke"])
def test_twin_names_a_port_script_with_flags_it_accepts(target):
    for argv in _commands(target):
        script, flags = _script_and_flags(argv)
        if script == "pytest":
            paths = [f for f in flags if not f.startswith("-")
                     and f != "not slow"]
            assert paths == ["tests/test_torch_*.py"]
            continue
        if script == "-c":
            assert "veles.simd_tpu_torch" in flags[0]
            assert "veles.simd_tpu " not in flags[0]
            continue
        assert script.endswith("_torch.py") or script == "chip_smoke.py", \
            script
        path = REPO / script
        assert path.exists(), script
        src = path.read_text()
        for flag in flags:
            if flag.startswith("--"):
                assert f'"{flag}"' in src, (target, flag)


def _jax_twin_pairs():
    pairs = []
    for t in _twin_targets():
        base = {v: k for k, v in RENAMED.items()}.get(t, t[:-len("-torch")])
        if base in _targets():
            pairs.append((base, t))
    return pairs


@pytest.mark.parametrize("jax_target,twin", _jax_twin_pairs())
def test_twin_passes_the_jax_targets_flags_and_environment(jax_target,
                                                           twin):
    jax_cmds = [c for c in _commands(jax_target)
                if "bench_regress.py" not in " ".join(c)]
    twin_cmds = _commands(twin)
    if jax_target == "cshim-check":
        return  # csrc's make against the port's cabi build: no flags
    assert len(jax_cmds) == len(twin_cmds)
    for jc, tc in zip(jax_cmds, twin_cmds):
        j_env = [w for w in jc if re.fullmatch(r"[A-Z_]+=.*", w)]
        t_env = [w for w in tc if re.fullmatch(r"[A-Z_]+=.*", w)]
        assert j_env == t_env
        (_js, jflags), (_ts, tflags) = (_script_and_flags(jc),
                                        _script_and_flags(tc))
        j_opts = [f for f in jflags if f.startswith("-")]
        t_opts = [f for f in tflags if f.startswith("-")]
        assert j_opts == t_opts, (jax_target, j_opts, t_opts)


def test_overrides_reach_the_twins():
    assert "--port 9100" in _dry_run("obs-dash-torch", OBS_PORT="9100")
    assert "--out p.json" in _dry_run("autotune-pack-torch",
                                      PACK_TORCH="p.json")
    assert "--dir wp" in _dry_run("warm-pack-torch", WARM_PACK_TORCH="wp")
    assert "x.json" in _dry_run("obs-report-torch", SNAPSHOT_TORCH="x.json")
    assert "'cpu' or None" in _dry_run("cabi-check-torch",
                                       CABI_PLATFORM="cpu")


SESSION = (REPO / "tools" / "hw_session_torch.sh").read_text()


@pytest.mark.parametrize("step", [
    "bench_torch.py --all", "tools/tpu_smoke_torch.py",
    "tools/benchmark_suite_torch.py", "tools/tune_conv2d_torch.py --quick",
    "tools/tune_overlap_save_torch.py", "tools/profile_overlap_save_torch.py",
    "tools/run_tests_torch.py --cuda", "tools/gen_wavelet_tables_torch.py",
    "chip_smoke.py"])
def test_the_card_session_runs_each_step_under_timeout(step):
    lines = [ln for ln in SESSION.replace("\\\n", " ").splitlines()
             if ln.startswith("run ") and step.split()[0] in ln]
    assert len(lines) == 1, step
    words = lines[0].split()
    assert words[2:4] == ["timeout", "-k"]
    assert " ".join(words).find(step.split()[0]) > 0
    for flag in step.split()[1:]:
        assert flag in words


def test_the_card_session_is_headline_first_and_names_the_card():
    runs = [ln.split()[1] for ln in SESSION.splitlines()
            if ln.startswith("run ")]
    assert runs[0] == "bench" and runs[-1] == "chip_smoke"
    assert "--quick" in SESSION.split("benchmark_suite_torch.py", 1)[1][:40]
    assert ("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader"
            in SESSION)
    assert "repro_pallas2d" not in SESSION.replace(
        "repro_pallas2d.py bisect", "")
    out = subprocess.run(["sh", "-n", str(REPO / "tools" /
                                          "hw_session_torch.sh")],
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr


def test_the_watcher_probes_the_port_and_fires_the_session():
    src = (REPO / "tools" / "watch_device_torch.sh").read_text()
    assert "veles.simd_tpu_torch.utils.platform import " \
           "probe_device_count" in src
    assert "exec sh tools/hw_session_torch.sh" in src
    assert "veles.simd_tpu.utils" not in src
    out = subprocess.run(["sh", "-n", str(REPO / "tools" /
                                          "watch_device_torch.sh")],
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("script", ["hw_session_torch.sh",
                                    "watch_device_torch.sh"])
def test_the_session_writes_inside_its_checkout(script):
    # two checkouts running the session never share a directory
    src = (REPO / "tools" / script).read_text()
    assert "/tmp" not in src
    assert 'OUT=${1:-$(dirname "$0")/../chiprun_out/hw_session}' in src
    assert "chiprun_out/" in (REPO / ".gitignore").read_text().split()


def test_the_session_default_lands_in_the_checkout(tmp_path):
    # every step fails at once (PYTHON=false), and its logs still land
    # under the copy's own chiprun_out/hw_session
    tools = tmp_path / "tools"
    tools.mkdir()
    shutil.copy(REPO / "tools" / "hw_session_torch.sh", tools)
    out = subprocess.run(["sh", str(tools / "hw_session_torch.sh")],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120, env={**os.environ, "PYTHON": "false"})
    assert out.returncode == 0, out.stderr
    session = tmp_path / "chiprun_out" / "hw_session"
    assert f"-> {session}" in out.stdout
    for step in ("bench", "smoke", "cuda_cov", "chip_smoke"):
        assert (session / f"{step}.out").exists(), step
        assert f"== {step}: rc=1" in out.stdout
