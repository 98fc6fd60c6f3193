"""The port's C ABI (``veles/simd_tpu_torch/cabi/``) on the CPU.

The bridge is built from the port's own copies of csrc's sources
(``cabi.build_library``), and ``csrc/test_veles_simd.c`` — the C suite
the JAX package's ``tests/test_cshim.py`` runs against csrc's library —
is compiled unchanged against it and run in the same four chunks, each
under its own timeout, with ``VELES_SIMD_PLATFORM=cpu``: every family
of the C suite passes on the port.  The port's header declares exactly
what csrc's declares.  The same suite on the card, with the platform
unset: chip_smoke's ``cabi`` phase.

Skips only where ``gcc``, ``python3-config`` or Python's headers are
missing.
"""

import re
import subprocess
from pathlib import Path

import pytest

from veles.simd_tpu_torch import cabi

REPO = Path(__file__).resolve().parent.parent

# tests/test_cshim.py's chunks; names must match g_families in
# csrc/test_veles_simd.c (the binary rejects unknown names with rc=2)
_CHUNKS = {
    "core": ["memory", "matrix", "convolve", "wavelet", "mathfun"],
    "spectral": ["spectral", "resample", "psd", "czt_ls"],
    "filters": ["iir", "filters", "waveforms", "normalize",
                "detect_peaks"],
    "abi": ["conversions", "arithmetic_family", "legacy_aliases"],
}
CHUNK_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def c_binary():
    if cabi.toolchain() is None:
        pytest.skip("gcc, python3-config or Python's headers unavailable")
    return cabi.build_program(REPO / "csrc" / "test_veles_simd.c")


@pytest.mark.parametrize("chunk", sorted(_CHUNKS))
def test_c_suite_chunk_passes_on_the_port(c_binary, chunk):
    run = subprocess.run([str(c_binary)] + _CHUNKS[chunk],
                         capture_output=True, text=True,
                         env=cabi.program_env("cpu"),
                         timeout=CHUNK_TIMEOUT_S)
    assert run.returncode == 0, (run.stdout[-2000:], run.stderr[-3000:])
    assert "0 failures" in run.stdout
    # the suite ran on the port, not on the JAX package's shim
    assert "backend: torch:cpu" in run.stdout


def test_chunks_cover_every_family(c_binary):
    listing = subprocess.run([str(c_binary), "bogus-family-name"],
                             capture_output=True, text=True,
                             env=cabi.program_env("cpu"), timeout=60)
    assert listing.returncode == 2
    known = set(listing.stderr.split("known:")[1].split())
    assert len(known) == 17
    assert {f for fams in _CHUNKS.values() for f in fams} == known


def test_c_demo_runs_on_the_port(c_binary):
    demo = cabi.build_program(REPO / "examples" / "c_matched_filter.c")
    run = subprocess.run([str(demo)], capture_output=True, text=True,
                         env=cabi.program_env("cpu"), timeout=240)
    assert run.returncode == 0, (run.stdout[-2000:], run.stderr[-3000:])
    assert "oracle peak agrees: yes" in run.stdout


def test_without_a_card_init_fails_with_the_message(c_binary):
    # the platform unset means the card; with none, veles_simd_init
    # returns -1 and veles_simd_last_error() says why (no CPU fallback)
    run = subprocess.run([str(c_binary), "memory"], capture_output=True,
                         text=True, env=cabi.program_env(),
                         timeout=CHUNK_TIMEOUT_S)
    import torch

    if torch.cuda.is_available():
        assert run.returncode == 0, run.stderr[-3000:]
        return
    assert run.returncode != 0
    assert "no CUDA card reachable" in run.stderr + run.stdout
    assert "VELES_SIMD_PLATFORM=cpu" in run.stderr + run.stdout


def _declarations(path: Path) -> list:
    text = path.read_text()
    text = re.sub(r"/\*.*?\*/", " ", text, flags=re.S)
    text = re.sub(r"//[^\n]*", " ", text)
    return " ".join(text.split()).split(";")


def test_header_declares_what_csrc_declares():
    assert _declarations(REPO / "veles" / "simd_tpu_torch" / "cabi"
                         / "veles_simd.h") \
        == _declarations(REPO / "csrc" / "veles_simd.h")


def test_bridge_imports_the_port_shim():
    src = (REPO / "veles" / "simd_tpu_torch" / "cabi"
           / "veles_simd.c").read_text()
    assert 'PyImport_ImportModule("veles.simd_tpu_torch.cshim")' in src
    assert '"veles.simd_tpu.cshim"' not in src
    # nothing is included from csrc/
    for path in (REPO / "veles" / "simd_tpu_torch" / "cabi").glob("*.[ch]"):
        assert "csrc/" not in "".join(
            line for line in path.read_text().splitlines()
            if line.startswith("#include"))


def test_library_keeps_csrc_file_name_and_is_reused(c_binary):
    lib = cabi.build_library()
    assert lib.name == "libveles_simd.so" == cabi.LIB_NAME
    assert lib.parent == c_binary.parent
    assert lib.parent.parent.name == "cabi"
    mtime = lib.stat().st_mtime_ns
    assert cabi.build_library() == lib       # found built, not rebuilt
    assert lib.stat().st_mtime_ns == mtime
