"""The port's artifact store (``veles/simd_tpu_torch/runtime/
artifacts.py``) on the CPU.

The store mechanics of ``tests/test_artifacts.py`` that carry over to a
store whose one entry is the nvcc-built kernel library: stale stamps
(schema, runtime, device, device-count class), a corrupt manifest, torn
and missing payloads, ``readonly`` never writing, a foreign manifest
refused on save, eviction, mode parsing, an ``off`` preload, the
profiler shim's delegation.  A packed stand-in library (random bytes
where nvcc's output would be: nothing here loads it) lands where
``cuda_kernels.load_library`` sees a cache hit; a stale or torn pack
places nothing.  A MANIFEST written by the JAX package's store is stale
to the port's, and the reverse.  The warm pack through a card process
(no nvcc, K1 launches): chip_smoke's ``artifacts`` phase.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from veles.simd_tpu.runtime import artifacts as jart
from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.ops import cuda_kernels as ck
from veles.simd_tpu_torch.runtime import artifacts as art
from veles.simd_tpu_torch.utils import config as tconfig


@pytest.fixture(autouse=True)
def _cpu_and_telemetry():
    prev = tconfig.get_config()
    tconfig.set_config(device="cpu")
    obs.enable()
    obs.reset()
    yield
    obs.reset()
    tconfig.set_config(**dataclasses.asdict(prev))


@pytest.fixture
def build_root(tmp_path):
    """A fresh, empty kernel build root for the test (the library is
    never loaded on the CPU, so the root may move)."""
    prev = ck.set_build_root()
    root = ck.set_build_root(tmp_path / "build_root")
    yield root
    ck.set_build_root(prev)


def _stand_in(seed=0):
    """Library bytes and a build log for the current sources."""
    rng = np.random.RandomState(seed)
    return rng.bytes(4096), b"ptxas info: stand-in build log\n"


def _built(lib, log):
    """Put a stand-in build where load_library looks; its directory."""
    out = ck._build_dir()
    out.mkdir(parents=True)
    (out / ck._LIB_NAME).write_bytes(lib)
    (out / "build.log").write_bytes(log)
    return out


def _pack(store_dir, seed=0):
    """An ``on``-mode pack of a stand-in library; returns its key and
    bytes, with the build root left empty again."""
    lib, log = _stand_in(seed)
    out = _built(lib, log)
    with art.private_artifact_store(store_dir) as st:
        with art.artifacts_mode_override("on"):
            assert art.store_kernel_library() == "stored"
        key, = st.keys()
    (out / ck._LIB_NAME).unlink()
    (out / "build.log").unlink()
    out.rmdir()
    return key, lib, log


def _edit_manifest(d, mutate):
    path = os.path.join(d, art.MANIFEST_NAME)
    with open(path) as f:
        data = json.load(f)
    mutate(data)
    with open(path, "w") as f:
        json.dump(data, f)


def _snapshot(d):
    return {name: open(os.path.join(d, name), "rb").read()
            for name in sorted(os.listdir(d))}


def test_all_is_the_jax_all():
    assert art.__all__ == jart.__all__
    for name in jart.__all__:
        assert hasattr(art, name), name
    for name in ("ARTIFACTS_ENV", "ARTIFACT_DIR_ENV", "ARTIFACT_MODES",
                 "ARTIFACT_SCHEMA", "MANIFEST_NAME",
                 "MAX_ARTIFACT_ENTRIES"):
        assert getattr(art, name) == getattr(jart, name), name


def test_stamps_name_torch_cuda_and_the_device():
    import torch

    stamp = art.version_stamp()
    assert torch.__version__ in stamp and "cuda" in stamp
    assert f"schema {art.ARTIFACT_SCHEMA}" in stamp
    assert art.device_stamp() == "cpu"
    assert art.devices_token() == "d1"


def test_a_pack_stamped_for_no_queried_card_is_stale(tmp_path,
                                                     build_root):
    # Config.device "cuda" with no card: the stamp is "unknown", and a
    # pack stamped so is never handed to the loader
    d = str(tmp_path / "pack")
    key, _, _ = _pack(d)
    _edit_manifest(d, lambda m: m.update(device="unknown"))
    tconfig.set_config(device="cuda")
    assert art.device_stamp() == "unknown"
    with art.private_artifact_store(d):
        with art.artifacts_mode_override("readonly"):
            assert art.lookup_runner(key) == (None, "stale")
    assert not (ck._build_dir() / ck._LIB_NAME).exists()


def test_key_is_the_build_directory_hash(tmp_path, build_root):
    key, _, _ = _pack(str(tmp_path / "pack"))
    assert key == "kernels|" + ck._build_dir().name
    entry = art.ArtifactStore(str(tmp_path / "pack")).entry(key)
    assert entry["op"] == "kernels" and entry["devices"] == "d1"


def test_packed_library_lands_where_load_library_hits(tmp_path,
                                                      build_root):
    d = str(tmp_path / "pack")
    key, lib, log = _pack(d)
    target = ck._build_dir() / ck._LIB_NAME
    assert not target.exists()
    with art.private_artifact_store(d) as st:
        with art.artifacts_mode_override("readonly"):
            report = art.preload()
        info = st.info()
    assert report == {"loaded": 1, "failed": 0, "mode": "readonly",
                      "path": d}
    # load_library's cache-hit test is exactly this file existing
    assert target.read_bytes() == lib
    assert (ck._build_dir() / "build.log").read_bytes() == log
    assert info["hits"] == 1 and info["preloaded"] == 1
    assert obs.counter_value("artifact_hit", op="kernels",
                             route="cuda") == 1
    assert obs.counter_value("artifact_preload") == 1
    events = [e for e in obs.events() if e["op"] == "artifact"]
    assert any(e["decision"] == "preload" and e["loaded"] == 1
               for e in events)


def test_preload_leaves_a_present_library_alone(tmp_path, build_root):
    d = str(tmp_path / "pack")
    _pack(d, seed=0)
    other, log = _stand_in(seed=1)
    out = _built(other, log)
    mtime = (out / ck._LIB_NAME).stat().st_mtime_ns
    with art.private_artifact_store(d):
        with art.artifacts_mode_override("readonly"):
            runner, outcome = art.lookup_runner("kernels|" + out.name)
    assert outcome == "hit" and runner == str(out / ck._LIB_NAME)
    assert (out / ck._LIB_NAME).read_bytes() == other
    assert (out / ck._LIB_NAME).stat().st_mtime_ns == mtime


def test_lookup_memoizes_the_placed_library(tmp_path, build_root):
    d = str(tmp_path / "pack")
    key, _, _ = _pack(d)
    with art.private_artifact_store(d) as st:
        with art.artifacts_mode_override("readonly"):
            first = art.lookup_runner(key)
            second = art.lookup_runner(key)
        assert st.info()["runners"] == 1 and st.info()["hits"] == 2
    assert first == second and first[1] == "hit"


@pytest.mark.parametrize("mutate, reason", [
    (lambda m: m.update(schema=99), "schema"),
    (lambda m: m.update(jax="torch 9.9.9/cuda 99.9/schema 1"), "runtime"),
    (lambda m: m.update(device="NVIDIA B200 sm_100"), "device"),
])
def test_stale_manifest_stamp_places_nothing(tmp_path, build_root,
                                             mutate, reason):
    d = str(tmp_path / "pack")
    _pack(d)
    _edit_manifest(d, mutate)
    with art.private_artifact_store(d) as st:
        with art.artifacts_mode_override("readonly"):
            report = art.preload()
        info = st.info()
    assert report["loaded"] == 0 and report["failed"] == 1, reason
    assert info["stale"] == 1 and info["hits"] == 0, reason
    assert obs.counter_value("artifact_stale", op="kernels",
                             route="cuda") == 1, reason
    assert not os.path.exists(build_root) or not os.listdir(build_root)


def test_stale_device_count_entry_places_nothing(tmp_path, build_root):
    d = str(tmp_path / "pack")
    key, _, _ = _pack(d)

    def mutate(m):
        for e in m["entries"].values():
            e["devices"] = "d999"

    _edit_manifest(d, mutate)
    with art.private_artifact_store(d) as st:
        with art.artifacts_mode_override("readonly"):
            runner, outcome = art.lookup_runner(key)
        assert st.info()["stale"] == 1
    assert runner is None and outcome == "stale"
    assert not (ck._build_dir() / ck._LIB_NAME).exists()


def test_stale_pack_lookup_reads_stale(tmp_path, build_root):
    d = str(tmp_path / "pack")
    key, _, _ = _pack(d)
    _edit_manifest(d, lambda m: m.update(device="TPU v5 lite"))
    with art.private_artifact_store(d):
        with art.artifacts_mode_override("readonly"):
            assert art.lookup_runner(key) == (None, "stale")
    events = [e for e in obs.events() if e["op"] == "artifact"]
    assert any(e["decision"] == "stale" for e in events)


def test_corrupt_manifest_degrades_to_empty(tmp_path, build_root):
    d = str(tmp_path / "pack")
    _pack(d)
    with open(os.path.join(d, art.MANIFEST_NAME), "w") as f:
        f.write("{ not json !!!")
    with art.private_artifact_store(d) as st:
        with art.artifacts_mode_override("readonly"):
            report = art.preload()
        info = st.info()
    assert report["loaded"] == 0
    assert info["load_errors"] == 1 and info["hits"] == 0
    assert obs.counter_value("artifact_load_error", op="kernels",
                             route="cuda") == 1
    assert not (ck._build_dir() / ck._LIB_NAME).exists()


def test_torn_payload_is_a_load_error_and_places_nothing(tmp_path,
                                                         build_root):
    d = str(tmp_path / "pack")
    key, _, _ = _pack(d)
    with art.private_artifact_store(d) as st:
        entry = st.entry(key)
        with open(os.path.join(d, entry["file"]), "r+b") as f:
            f.truncate(entry["size"] // 2)
        with art.artifacts_mode_override("readonly"):
            report = art.preload()
        info = st.info()
    assert report["loaded"] == 0 and report["failed"] == 1
    assert info["load_errors"] == 1
    assert obs.counter_value("artifact_load_error", op="kernels",
                             route="cuda") == 1
    assert not (ck._build_dir() / ck._LIB_NAME).exists()


def test_missing_payload_file_is_a_miss(tmp_path, build_root):
    d = str(tmp_path / "pack")
    key, _, _ = _pack(d)
    with art.private_artifact_store(d) as st:
        os.unlink(os.path.join(d, st.entry(key)["file"]))
        data, outcome = st.load_bytes(key)
    assert data is None and outcome == "load_error"


def test_payload_with_a_foreign_member_places_nothing(tmp_path,
                                                      build_root):
    # a payload whose digest matches but whose tar holds another path
    # (a hand-built pack) never writes outside the build directory
    import io
    import tarfile

    d = str(tmp_path / "pack")
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tar:
        data = b"x" * 64
        info = tarfile.TarInfo("../escaped.so")
        info.size = len(data)
        tar.addfile(info, io.BytesIO(data))
    key = "kernels|" + ck._build_dir().name
    with art.private_artifact_store(d) as st:
        with art.artifacts_mode_override("on"):
            assert st.store_bytes(key, buf.getvalue(), op="kernels")
        with art.artifacts_mode_override("readonly"):
            assert art.lookup_runner(key) == (None, "load_error")
    assert not (tmp_path / "escaped.so").exists()
    assert not (ck._build_dir() / ck._LIB_NAME).exists()


def test_readonly_mode_never_writes(tmp_path, build_root):
    d = str(tmp_path / "pack")
    _pack(d)
    before = _snapshot(d)
    lib, log = _stand_in(seed=3)
    with art.private_artifact_store(d) as st:
        with art.artifacts_mode_override("readonly"):
            assert art.preload()["loaded"] == 1
            assert art.store_kernel_library() == "refused"
            assert not st.store_bytes("k", b"data")
            art.on_library_loaded(ck._build_dir())
        info = st.info()
    assert info["stores"] == 0 and info["write_refused"] >= 1
    assert _snapshot(d) == before


def test_save_refuses_foreign_manifest(tmp_path, build_root):
    d = str(tmp_path / "pack")
    os.makedirs(d)
    foreign = {"schema": art.ARTIFACT_SCHEMA,
               "jax": "torch 9.9.9/cuda 99.9/schema 1",
               "device": "NVIDIA B200 sm_100", "entries": {}}
    with open(os.path.join(d, art.MANIFEST_NAME), "w") as f:
        json.dump(foreign, f)
    _built(*_stand_in())
    with art.private_artifact_store(d) as st:
        with art.artifacts_mode_override("on"):
            assert art.store_kernel_library() == "refused"
        info = st.info()
    assert info["save_refused"] >= 1
    with open(os.path.join(d, art.MANIFEST_NAME)) as f:
        assert json.load(f)["device"] == "NVIDIA B200 sm_100"


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_manifest_of_the_other_package_is_stale(tmp_path, writer):
    # the runtime stamp keeps the JAX field name: each package reads
    # the other's manifest as stale, and loads nothing from it
    d = str(tmp_path / "pack")
    mods = {"jax": jart, "port": art}
    src = mods[writer]
    dst = mods["port" if writer == "jax" else "jax"]
    with src.private_artifact_store(d) as st:
        with src.artifacts_mode_override("on"):
            assert st.store_bytes("k", b"payload", op="x")
    with dst.private_artifact_store(d) as st:
        with dst.artifacts_mode_override("readonly"):
            data, outcome = st.load_bytes("k")
        info = st.info()
    assert data is None and outcome == "miss"
    assert info["stale"] == 1 and info["size"] == 0


def test_store_eviction_bounds_entries(tmp_path, monkeypatch):
    monkeypatch.setattr(art, "MAX_ARTIFACT_ENTRIES", 3)
    d = str(tmp_path / "pack")
    with art.private_artifact_store(d) as st:
        with art.artifacts_mode_override("on"):
            for i in range(5):
                st.store_bytes(f"key{i}", b"payload%d" % i)
        info = st.info()
    assert info["size"] == 3 and info["evictions"] == 2
    bins = [p for p in os.listdir(d) if p.endswith(".bin")]
    assert len(bins) == 3
    with open(os.path.join(d, art.MANIFEST_NAME)) as f:
        entries = json.load(f)["entries"]
    assert sorted(entries) == ["key2", "key3", "key4"]
    with art.private_artifact_store(d) as st2:
        for key in sorted(entries):
            assert st2.load_bytes(key)[1] == "hit", key


def test_mode_parsing(monkeypatch):
    monkeypatch.setenv(art.ARTIFACTS_ENV, "readonly")
    assert art.artifacts_mode() == "readonly"
    monkeypatch.setenv(art.ARTIFACTS_ENV, " ON ")
    assert art.artifacts_mode() == "on"
    monkeypatch.setenv(art.ARTIFACTS_ENV, "bogus")
    assert art.artifacts_mode() == "off"
    monkeypatch.delenv(art.ARTIFACTS_ENV)
    assert art.artifacts_mode() == "off"
    with art.artifacts_mode_override("on"):
        assert art.artifacts_mode() == "on"
    assert art.artifacts_mode() == "off"
    with pytest.raises(ValueError):
        with art.artifacts_mode_override("sideways"):
            pass


def test_preload_off_mode_is_a_noop(tmp_path, build_root):
    d = str(tmp_path / "pack")
    _pack(d)
    with art.private_artifact_store(d):
        report = art.preload()
    assert report == {"loaded": 0, "failed": 0, "mode": "off", "path": d}
    assert not (ck._build_dir() / ck._LIB_NAME).exists()


def test_unbound_store_preloads_nothing():
    with art.private_artifact_store(None):
        with art.artifacts_mode_override("readonly"):
            assert art.preload() == {"loaded": 0, "failed": 0,
                                     "mode": "readonly", "path": None}
            assert art.lookup_runner("kernels|0") == (None, "miss")


def test_load_hook_stores_once_a_process_in_on_mode(tmp_path, build_root):
    d = str(tmp_path / "pack")
    out = _built(*_stand_in())
    with art.private_artifact_store(d) as st:
        with art.artifacts_mode_override("off"):
            art.on_library_loaded(out)
        assert st.info()["stores"] == 0
        with art.artifacts_mode_override("on"):
            art.on_library_loaded(out)
            art.on_library_loaded(out)
        assert st.info()["stores"] == 1
        assert st.keys() == ["kernels|" + out.name]


def test_store_without_a_built_library_is_refused(tmp_path, build_root):
    with art.private_artifact_store(str(tmp_path / "pack")) as st:
        with art.artifacts_mode_override("on"):
            assert art.store_kernel_library() == "refused"
        assert st.info()["stores"] == 0


@pytest.mark.parametrize("mode, want", [("on", "unsupported"),
                                        ("readonly", "refused"),
                                        ("off", "refused")])
def test_export_is_unsupported_or_refused(tmp_path, mode, want):
    with art.private_artifact_store(str(tmp_path / "pack")) as st:
        with art.artifacts_mode_override(mode):
            got = art.export_and_store(lambda x: x, "k", (1,), {},
                                       op="o", route="r")
        info = st.info()
    assert got == want
    assert info["export_unsupported"] == (1 if mode == "on" else 0)
    assert info["stores"] == 0


def test_instrumented_jit_ignores_artifact_key(tmp_path):
    import torch

    with art.private_artifact_store(str(tmp_path / "pack")) as st:
        with art.artifacts_mode_override("on"):
            fn = obs.instrumented_jit(lambda x: x * 2.0, op="k",
                                      artifact_key="scale=2")
            y = fn(torch.ones(4))
        info = st.info()
    assert torch.equal(y, torch.full((4,), 2.0))
    assert info["stores"] == 0 and info["misses"] == 0


def test_stats_surface_in_obs_caches(tmp_path, build_root):
    d = str(tmp_path / "pack")
    _pack(d)
    _edit_manifest(d, lambda m: m.update(device="TPU v99"))
    with art.private_artifact_store(d):
        with art.artifacts_mode_override("readonly"):
            art.preload()
            snap = obs.caches()["artifact_store"]
    for key in ("path", "mode", "hits", "misses", "stale", "evictions"):
        assert key in snap
    assert snap["stale"] == 1 and snap["mode"] == "readonly"


def test_profiler_shim_delegates(tmp_path, monkeypatch):
    from veles.simd_tpu_torch.utils import profiler

    prev = ck.set_build_root()
    try:
        assert profiler.enable_compilation_cache(str(tmp_path / "a")) \
            == str(tmp_path / "a") == ck.set_build_root()
        monkeypatch.setenv("VELES_SIMD_CACHE_DIR", str(tmp_path / "b"))
        assert art.enable_persistent_compile_cache() \
            == str(tmp_path / "b") == profiler.enable_compilation_cache()
    finally:
        ck.set_build_root(prev)
