"""The artifact store of the port: the nvcc-built kernel library,
shipped like a tune pack.

The port of ``veles.simd_tpu.runtime.artifacts``.  In the JAX package
every fresh process pays trace + compile per (op, route, geometry)
before its first fast request, and the store ships ``jax.export``-
serialized executables so it does not.  Eager PyTorch compiles no
program per geometry; the port's one compiled program is the CUDA
kernel library, which ``nvcc`` builds at first use
(``ops/cuda_kernels.load_library``) and which every fresh host or
fresh build directory pays for before its first launch.  So an entry
here holds that library and its ``build.log``:

* **the store** — a directory of payloads plus one ``MANIFEST.json``,
  the JAX package's layout and discipline: schema version, a runtime
  stamp, the device stamp, per-entry sha256 and device-count class,
  atomic writes, eviction at :data:`MAX_ARTIFACT_ENTRIES`,
  ``readonly`` never writing, ``save`` refusing to overwrite a valid
  manifest stamped for another runtime.  A corrupt manifest, a torn
  or missing payload and a stale stamp degrade to a miss with their
  counters (``artifact_miss`` / ``artifact_stale`` /
  ``artifact_load_error`` and an ``artifact`` decision event) — never
  a crash, and never a library stamped for another card, torch or
  CUDA.  The runtime stamp keeps the JAX manifest's field name
  (``"jax"``), holding :func:`version_stamp`: a manifest written by
  either package is stale to the other;

* **the key** — ``kernels|<hash>``, the hash of the kernels' sources
  and nvcc flags that names the library's build directory
  (``cuda_kernels._build_dir``);

* **storing** — in ``on`` mode ``load_library`` stores the library it
  loaded (built, or found built) once a process
  (:func:`store_kernel_library`, also callable directly to pack a
  library already loaded);

* **loading** — :func:`lookup_runner` / :func:`preload` verify the
  entry's sha256 and stamps, then write the library and its log
  atomically into ``<build root>/<hash>/`` unless they are there
  already, so ``load_library`` takes its cache-hit path and no nvcc
  runs.  ``serve.Server.start()`` preloads when the store is armed
  (thread replicas, and a subprocess child before its ready line).
  The "runner" of a hit is the placed library's path;

* **the persistent-compile-cache leg** —
  :func:`enable_persistent_compile_cache` is the one home of
  ``cuda_kernels.set_build_root`` (the build directory is the port's
  persistent compile cache); ``utils/profiler.enable_compilation_cache``
  delegates to it.  Arming the store does not move the build root:
  a ``readonly`` pack is never written into;

* **export** — :func:`export_and_store` returns ``"unsupported"``
  (counted as ``export_unsupported``) wherever the JAX package would
  export: an eager torch callable has no serializable program per
  geometry, the JAX outcome for what ``jax.export`` cannot serialize.
  ``obs.instrumented_jit`` ignores ``artifact_key`` for that reason.

Modes (``$VELES_SIMD_ARTIFACTS``): ``off`` (default), ``on`` (load,
and store the loaded library), ``readonly`` (load only; the store
never writes).  ``$VELES_SIMD_ARTIFACT_DIR`` names the store
directory; :func:`set_artifact_dir` is the programmatic override and
:func:`private_artifact_store` the thread-scoped test idiom.  This
module imports neither torch nor the kernels at module scope.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import tarfile
import threading
import time
from pathlib import Path

from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.obs.atomic import (atomic_write_bytes,
                                             atomic_write_text)

__all__ = [
    "ARTIFACTS_ENV", "ARTIFACT_DIR_ENV", "ARTIFACT_MODES",
    "ARTIFACT_SCHEMA", "MANIFEST_NAME", "MAX_ARTIFACT_ENTRIES",
    "ArtifactStore", "artifacts_mode", "artifacts_mode_override",
    "artifact_dir", "set_artifact_dir", "store",
    "private_artifact_store", "lookup_runner", "export_and_store",
    "preload", "enable_persistent_compile_cache", "version_stamp",
    "device_stamp", "devices_token",
]

ARTIFACTS_ENV = "VELES_SIMD_ARTIFACTS"
ARTIFACT_DIR_ENV = "VELES_SIMD_ARTIFACT_DIR"
ARTIFACT_MODES = ("off", "on", "readonly")

# artifact-store schema version: a manifest written by a different
# layout is ignored wholesale (counted as stale)
ARTIFACT_SCHEMA = 1

MANIFEST_NAME = "MANIFEST.json"

# entry bound: oldest-stamp entries are evicted on store (the TuneCache
# discipline); one entry a source revision of the kernels
MAX_ARTIFACT_ENTRIES = 256

# placed-library memo bound (in-memory, per store)
RUNNER_CACHE_MAX = 256

# the kernel library's key prefix, and the members of its payload
KERNELS_PREFIX = "kernels|"
_LIB_MEMBER = "libveles_simd_torch.so"
_LOG_MEMBER = "build.log"


def artifacts_mode() -> str:
    """The active artifact-store mode (``$VELES_SIMD_ARTIFACTS``, or a
    thread-scoped :func:`artifacts_mode_override`): ``off`` (default),
    ``on`` or ``readonly``.  Unknown values read as ``off``: a typo'd
    env var must not change dispatch or crash a service."""
    override = getattr(_tls, "mode", None)
    raw = (override if override is not None
           else os.environ.get(ARTIFACTS_ENV, "off")).strip().lower()
    return raw if raw in ARTIFACT_MODES else "off"


_tls = threading.local()


@contextlib.contextmanager
def artifacts_mode_override(mode: str):
    """Scoped, THREAD-LOCAL mode override (the supervised-worker idiom
    shared with ``routing.autotune_mode_override``)."""
    if mode not in ARTIFACT_MODES:
        raise ValueError(f"mode must be one of {ARTIFACT_MODES}, "
                         f"got {mode!r}")
    prev = getattr(_tls, "mode", None)
    _tls.mode = mode
    try:
        yield
    finally:
        _tls.mode = prev


def version_stamp() -> str:
    """The runtime stamp of every manifest: the schema, torch's version
    and the CUDA version torch was built with.  A library built for
    one runtime generation never loads into another."""
    import torch

    return (f"torch {torch.__version__}/cuda {torch.version.cuda}/"
            f"schema {ARTIFACT_SCHEMA}")


def device_stamp() -> str:
    """The device stamp: the card's name and ``sm_XY`` (the
    architecture the library's code must match), or ``cpu`` where
    ``Config.device`` is the host (``unknown`` if the card cannot be
    queried)."""
    import torch

    from veles.simd_tpu_torch.runtime import routing

    kind = routing.device_kind()
    if kind in ("cpu", "unknown"):
        return kind
    try:
        major, minor = torch.cuda.get_device_capability()
    except Exception:  # noqa: BLE001 — no runtime: never matches a pack
        return "unknown"
    return f"{kind} sm_{major}{minor}"


def devices_token() -> str:
    """Per-entry device-count class (``d1``, ``d4``, ...): the cards
    this process sees where ``Config.device`` is a card, ``d1`` on the
    host."""
    import torch

    from veles.simd_tpu_torch.utils.config import get_config

    if get_config().device == "cuda" and torch.cuda.is_available():
        return f"d{torch.cuda.device_count()}"
    return "d1"


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------


def _digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _key_file(key: str) -> str:
    """Stable per-key filename (entries live under the key's sha256)."""
    return _digest(key.encode("utf-8"))[:40] + ".bin"


class ArtifactStore:
    """One artifact directory: payloads + MANIFEST.json.

    Manifest format (JSON, atomically written)::

        {"schema": 1, "jax": "<version_stamp()>",
         "device": "NVIDIA H100 80GB HBM3 sm_90",
         "entries": {"kernels|<hash>": {"file": "<sha>.bin",
                                        "sha256": "...", "size": 12345,
                                        "unix": ..., "op": "kernels",
                                        "route": "cuda",
                                        "devices": "d1"}, ...}}

    A corrupt manifest, a schema/runtime/device stamp from a different
    runtime, a per-entry device-count mismatch, a missing or
    digest-mismatched ``.bin`` (torn write) — every one degrades to a
    MISS with its counter bumped (``stale`` / ``load_errors``).
    ``readonly`` mode never writes (``write_refused`` counts the
    refusals); ``save`` refuses to overwrite a VALID manifest stamped
    for another runtime (``save_refused``).
    """

    def __init__(self, path: str | None):
        self._lock = threading.Lock()
        self._save_lock = threading.Lock()
        self._path = path
        self._entries: dict[str, dict] = {}
        self._loaded = path is None
        self._manifest = "missing"
        # keys evicted by THIS store (their payload files unlinked):
        # save()'s read-merge-write must not resurrect them
        self._evicted_keys: set = set()
        self._runners: dict[str, object] = {}
        self._stats = {"hits": 0, "misses": 0, "stale": 0,
                       "load_errors": 0, "stores": 0, "evictions": 0,
                       "persist_errors": 0, "save_refused": 0,
                       "write_refused": 0, "export_unsupported": 0,
                       "preloaded": 0}

    @property
    def path(self) -> str | None:
        return self._path

    def _manifest_path(self) -> str:
        return os.path.join(self._path, MANIFEST_NAME)

    def _read_manifest(self) -> "dict | str":
        """Validated entries, or the rejection reason (the stat to
        bump: ``'missing'`` / ``'load_errors'`` / ``'stale'``)."""
        try:
            with open(self._manifest_path()) as f:
                data = json.load(f)
        except FileNotFoundError:
            return "missing"
        except Exception:  # noqa: BLE001 — corrupt manifest degrades
            return "load_errors"
        if not isinstance(data, dict) or \
                data.get("schema") != ARTIFACT_SCHEMA:
            return "stale"
        stamp = data.get("jax")
        if stamp is not None and stamp != version_stamp():
            return "stale"
        dev = data.get("device")
        # a card that could not be queried ("unknown") names no card:
        # nothing stamped so is ever handed to the loader
        if dev is not None and (dev != device_stamp() or dev == "unknown"):
            return "stale"
        entries = data.get("entries")
        if not isinstance(entries, dict):
            return "load_errors"
        return {str(k): dict(v) for k, v in entries.items()
                if isinstance(v, dict)
                and isinstance(v.get("file"), str)}

    def _ensure_loaded_locked(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        loaded = self._read_manifest()
        if isinstance(loaded, dict):
            self._entries.update(loaded)
            self._manifest = "ok"
        else:
            self._manifest = loaded
            if loaded != "missing":
                self._stats[loaded] += 1

    def manifest_outcome(self) -> str:
        """How the manifest read when this store loaded it: ``ok``,
        ``missing``, ``stale`` or ``load_errors``."""
        with self._lock:
            self._ensure_loaded_locked()
            return self._manifest

    # -- reads ---------------------------------------------------------------

    def load_bytes(self, key: str) -> "tuple[bytes | None, str]":
        """``(data, outcome)`` for one key: outcome is ``hit`` /
        ``miss`` / ``stale`` (per-entry device-count mismatch) /
        ``load_error`` (missing/torn/digest-mismatched file)."""
        with self._lock:
            self._ensure_loaded_locked()
            entry = self._entries.get(key)
            if entry is None:
                self._stats["misses"] += 1
                return None, "miss"
            stamp = entry.get("devices")
            if stamp is not None and stamp != devices_token():
                self._stats["stale"] += 1
                self._stats["misses"] += 1
                return None, "stale"
            fname = entry["file"]
            want = entry.get("sha256")
        try:
            with open(os.path.join(self._path, fname), "rb") as f:
                data = f.read()
        except Exception:  # noqa: BLE001 — a vanished file is a miss
            with self._lock:
                self._stats["load_errors"] += 1
                self._stats["misses"] += 1
            return None, "load_error"
        if want is not None and _digest(data) != want:
            # a torn or tampered payload never reaches the loader
            with self._lock:
                self._stats["load_errors"] += 1
                self._stats["misses"] += 1
            return None, "load_error"
        with self._lock:
            self._stats["hits"] += 1
        return data, "hit"

    def keys(self) -> list:
        with self._lock:
            self._ensure_loaded_locked()
            return sorted(self._entries)

    def entry(self, key: str) -> dict | None:
        with self._lock:
            self._ensure_loaded_locked()
            e = self._entries.get(key)
            return dict(e) if e is not None else None

    # -- runners -------------------------------------------------------------

    def runner(self, key: str):
        """The memoized placed-library path for ``key``, or None (no
        hit/miss accounting — :func:`lookup_runner` owns that)."""
        with self._lock:
            return self._runners.get(key)

    def put_runner(self, key: str, runner) -> None:
        with self._lock:
            if len(self._runners) >= RUNNER_CACHE_MAX:
                self._runners.pop(next(iter(self._runners)))
            self._runners[key] = runner

    # -- writes --------------------------------------------------------------

    def store_bytes(self, key: str, data: bytes, *, op: str = "",
                    route: str = "") -> bool:
        """Persist one payload under ``key``; returns True when it
        landed.  Refused (counted, never raised) in readonly mode,
        with no bound directory, or when persistence fails."""
        if self._path is None:
            return False
        if artifacts_mode() == "readonly":
            with self._lock:
                self._stats["write_refused"] += 1
            return False
        data = bytes(data)
        fname = _key_file(key)
        entry = {"file": fname, "sha256": _digest(data),
                 "size": len(data), "unix": time.time(),
                 "op": str(op), "route": str(route),
                 "devices": devices_token()}
        try:
            os.makedirs(self._path, exist_ok=True)
            atomic_write_bytes(os.path.join(self._path, fname), data)
        except Exception:  # noqa: BLE001
            with self._lock:
                self._stats["persist_errors"] += 1
            return False
        with self._lock:
            self._entries.pop(key, None)
            self._entries[key] = entry
            self._evicted_keys.discard(key)
            self._stats["stores"] += 1
            evicted = []
            while len(self._entries) > MAX_ARTIFACT_ENTRIES:
                oldest = min(self._entries,
                             key=lambda k: self._entries[k].get(
                                 "unix", 0.0))
                evicted.append(self._entries.pop(oldest))
                self._evicted_keys.add(oldest)
                self._stats["evictions"] += 1
        for e in evicted:
            try:        # best effort — the manifest is the truth
                os.unlink(os.path.join(self._path, e["file"]))
            except OSError:
                pass
        return self.save()

    def save(self) -> bool:
        """Atomically persist the manifest (read-merge-write under a
        save lock).  A VALID manifest stamped for another runtime is
        never overwritten (``save_refused``)."""
        if self._path is None or artifacts_mode() == "readonly":
            return False
        with self._save_lock:
            with self._lock:
                self._ensure_loaded_locked()
                on_disk = self._read_manifest()
                if on_disk == "stale":
                    self._stats["save_refused"] += 1
                    return False
                merged = on_disk if isinstance(on_disk, dict) else {}
                for key in self._evicted_keys:
                    merged.pop(key, None)
                merged.update(self._entries)
                while len(merged) > MAX_ARTIFACT_ENTRIES:
                    merged.pop(min(merged,
                                   key=lambda k: merged[k].get(
                                       "unix", 0.0)))
                payload = {"schema": ARTIFACT_SCHEMA,
                           "jax": version_stamp(),
                           "device": device_stamp(),
                           "entries": merged}
            try:
                os.makedirs(self._path, exist_ok=True)
                atomic_write_text(self._manifest_path(),
                                  json.dumps(payload, indent=1,
                                             sort_keys=True))
                return True
            except Exception:  # noqa: BLE001
                with self._lock:
                    self._stats["persist_errors"] += 1
                return False

    # -- introspection -------------------------------------------------------

    def info(self) -> dict:
        """``obs.caches()`` provider payload — path, mode, and the
        hit/miss/stale/eviction traffic."""
        with self._lock:
            self._ensure_loaded_locked()
            return {"size": len(self._entries),
                    "capacity": MAX_ARTIFACT_ENTRIES,
                    "path": self._path, "mode": artifacts_mode(),
                    "schema": ARTIFACT_SCHEMA,
                    "runners": len(self._runners), **self._stats}


# ---------------------------------------------------------------------------
# the process store singleton (rebuilt when the bound dir changes)
# ---------------------------------------------------------------------------

_store_lock = threading.Lock()
_dir_override: str | None = None
_store_src: object = None
_store_obj: ArtifactStore | None = None
_NO_PATH = object()


def artifact_dir() -> str | None:
    """The bound artifact directory (programmatic override first, then
    ``$VELES_SIMD_ARTIFACT_DIR``), or None."""
    if _dir_override is not None:
        return _dir_override
    return os.environ.get(ARTIFACT_DIR_ENV, "").strip() or None


def set_artifact_dir(path: str | None) -> None:
    """Programmatic artifact-dir override (None restores the env
    lookup).  The next :func:`store` call rebuilds the singleton."""
    global _dir_override, _store_src, _store_obj
    with _store_lock:
        _dir_override = path
        _store_src = _NO_PATH
        _store_obj = None


def store() -> ArtifactStore:
    """The process artifact store, rebuilt when the bound directory
    changes.  A thread-scoped :func:`private_artifact_store` takes
    precedence."""
    global _store_src, _store_obj
    private = getattr(_tls, "store", None)
    if private is not None:
        return private
    path = artifact_dir()
    with _store_lock:
        if _store_obj is None or path != _store_src:
            _store_src = path
            _store_obj = ArtifactStore(path)
        return _store_obj


@contextlib.contextmanager
def private_artifact_store(path: str | None = None):
    """Scoped, THREAD-LOCAL artifact store: inside the scope this
    thread's lookups and stores go to a private store instead of the
    process one.  Yields the private store."""
    prev = getattr(_tls, "store", None)
    st = ArtifactStore(path)
    _tls.store = st
    try:
        yield st
    finally:
        _tls.store = prev


obs.register_cache("artifact_store", lambda: store().info())


# ---------------------------------------------------------------------------
# the persistent-compile-cache leg (ONE home; utils/profiler delegates here)
# ---------------------------------------------------------------------------

_COMPILE_CACHE_ENV = "VELES_SIMD_CACHE_DIR"


def enable_persistent_compile_cache(cache_dir: str | None = None
                                    ) -> str:
    """Where the CUDA kernel library is built and found again by later
    processes (``cuda_kernels.set_build_root``); returns the directory
    in use.

    ``cache_dir`` (or ``$VELES_SIMD_CACHE_DIR`` when it is None and the
    variable is set) becomes the build root before the library's first
    load; without either the root stays ``build/simd_tpu_torch/`` under
    the checkout.  The library lands in ``<root>/<hash of sources and
    flags>/``.  After the first load the root cannot move: a different
    directory raises ``RuntimeError``, the one in use is returned.
    This is the single home of the configuration —
    ``utils/profiler.enable_compilation_cache`` delegates here."""
    from veles.simd_tpu_torch.ops import cuda_kernels

    if cache_dir is None:
        cache_dir = os.environ.get(_COMPILE_CACHE_ENV) or None
    return cuda_kernels.set_build_root(cache_dir)


# ---------------------------------------------------------------------------
# the kernel library: pack, place
# ---------------------------------------------------------------------------


def _pack(lib: bytes, log: bytes) -> bytes:
    """One payload: an uncompressed tar of the library and its log."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tar:
        for name, data in ((_LIB_MEMBER, lib), (_LOG_MEMBER, log)):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            info.mode = 0o755 if name == _LIB_MEMBER else 0o644
            tar.addfile(info, io.BytesIO(data))
    return buf.getvalue()


def _unpack(data: bytes) -> dict:
    """``{member name: bytes}`` of a payload: exactly the library and
    its log (any other layout raises)."""
    out = {}
    with tarfile.open(fileobj=io.BytesIO(data), mode="r") as tar:
        for info in tar.getmembers():
            if info.name not in (_LIB_MEMBER, _LOG_MEMBER) \
                    or not info.isfile() or info.name in out:
                raise ValueError(f"unexpected payload member {info.name!r}")
            out[info.name] = tar.extractfile(info).read()
    if set(out) != {_LIB_MEMBER, _LOG_MEMBER}:
        raise ValueError(f"payload members {sorted(out)}")
    return out


def _place(key: str, data: bytes) -> str:
    """Write a payload's library and log into ``<build root>/<hash>/``
    (atomically, and only what is not there already); returns the
    library's path."""
    from veles.simd_tpu_torch.ops import cuda_kernels

    digest = key[len(KERNELS_PREFIX):]
    if not key.startswith(KERNELS_PREFIX) or not digest.isalnum():
        raise ValueError(f"not a kernel-library key: {key!r}")
    members = _unpack(data)
    out_dir = Path(cuda_kernels.set_build_root()) / digest
    lib = out_dir / _LIB_MEMBER
    if lib.exists() and (out_dir / _LOG_MEMBER).exists():
        return str(lib)
    out_dir.mkdir(parents=True, exist_ok=True)
    # the log first: a library that is there has its log beside it
    atomic_write_bytes(str(out_dir / _LOG_MEMBER), members[_LOG_MEMBER])
    atomic_write_bytes(str(lib), members[_LIB_MEMBER])
    os.chmod(lib, 0o755)
    return str(lib)


_stored_once: set = set()
_stored_lock = threading.Lock()


def store_kernel_library(lib_dir=None) -> str:
    """Pack the kernel library in ``lib_dir`` (default: the current
    sources' build directory) and its ``build.log`` into the store
    under ``kernels|<hash>``.  Returns the outcome: ``stored``, or
    ``refused`` (mode not ``on``, no bound directory, nothing built,
    or the write refused).  Never raises.  ``load_library`` calls it
    once a process in ``on`` mode; this is the port's own entry (the
    JAX package stores from its compile site), kept out of
    ``__all__``."""
    from veles.simd_tpu_torch.ops import cuda_kernels

    st = store()
    if st.path is None or artifacts_mode() != "on":
        return "refused"
    try:
        lib_dir = Path(lib_dir) if lib_dir is not None \
            else cuda_kernels._build_dir()
        data = _pack((lib_dir / _LIB_MEMBER).read_bytes(),
                     (lib_dir / _LOG_MEMBER).read_bytes())
    except OSError:
        return "refused"
    key = KERNELS_PREFIX + lib_dir.name
    ok = st.store_bytes(key, data, op="kernels", route="cuda")
    obs.record_decision("artifact", "stored" if ok else "refused",
                        site="kernels", key=key)
    return "stored" if ok else "refused"


def on_library_loaded(lib_dir) -> None:
    """``load_library``'s hook: in ``on`` mode, store the loaded
    library once a process per store directory.  Never raises."""
    if artifacts_mode() != "on":
        return
    st = store()
    token = (st.path, str(lib_dir))
    with _stored_lock:
        if st.path is None or token in _stored_once:
            return
        _stored_once.add(token)
    try:
        store_kernel_library(lib_dir)
    except Exception:  # noqa: BLE001 — a failed store never stops a load
        obs.count("artifact_store_error")


# ---------------------------------------------------------------------------
# export / load
# ---------------------------------------------------------------------------


def export_and_store(jfn, key: str, args, kwargs, *, op: str = "",
                     route: str = "") -> str:
    """The JAX package's export of a jitted callable at one geometry.
    The port compiles no program per geometry, so an armed ``on``
    store returns ``unsupported`` (counted as ``export_unsupported``,
    the JAX outcome for a program ``jax.export`` cannot serialize);
    ``refused`` where the JAX package refuses (readonly / off / unbound
    directory).  Never raises."""
    del jfn, key, args, kwargs, op, route
    st = store()
    if st.path is None or artifacts_mode() != "on":
        return "refused"
    with st._lock:
        st._stats["export_unsupported"] += 1
    return "unsupported"


def lookup_runner(key: str) -> tuple:
    """``(library path, outcome)`` for one key: on a hit the entry's
    sha256 and stamps are verified and the library and its log are
    placed under the build root, so ``load_library`` finds them built.
    Outcomes: ``hit``, ``miss``, ``stale``, ``load_error`` (a payload
    that does not unpack or place is one).  Each outcome counts
    ``artifact_<outcome>`` and records an ``artifact`` decision event.
    Never raises."""
    st = store()
    if st.path is None:
        return None, "miss"
    runner = st.runner(key)
    if runner is not None and os.path.exists(runner):
        with st._lock:
            st._stats["hits"] += 1
        _note(key, "hit")
        return runner, "hit"
    data, outcome = st.load_bytes(key)
    if data is None:
        # a manifest stamped for another card, torch or CUDA (or one
        # that does not parse) lists nothing: every key of it reads so
        outcome = {"stale": "stale", "load_errors": "load_error"}.get(
            st.manifest_outcome(), outcome)
        _note(key, outcome)
        return None, outcome
    try:
        runner = _place(key, data)
    except Exception:  # noqa: BLE001 — a bad payload must not crash
        with st._lock:
            st._stats["load_errors"] += 1
        _note(key, "load_error")
        return None, "load_error"
    st.put_runner(key, runner)
    _note(key, "hit")
    return runner, "hit"


def _note(key: str, outcome: str) -> None:
    obs.count(f"artifact_{outcome}", op="kernels", route="cuda")
    obs.record_decision("artifact", outcome, site="kernels", key=key)


def preload(keys=None) -> dict:
    """Place every store entry (or just ``keys``) under the build root
    NOW — the serve-start warmup that moves the nvcc build out of the
    first request's critical path.  Returns ``{"loaded": n, "failed":
    m, "mode": ..., "path": ...}``; failures are counted, never raised
    (a torn pack must not stop a server from starting cold).  A stale
    or corrupt manifest is one failure, counted as ``artifact_stale`` /
    ``artifact_load_error``: its entries are never listed."""
    st = store()
    out = {"loaded": 0, "failed": 0, "mode": artifacts_mode(),
           "path": st.path}
    if artifacts_mode() == "off" or st.path is None:
        return out
    if keys is None:
        keys = st.keys()
        rejected = {"stale": "stale", "load_errors": "load_error"}.get(
            st.manifest_outcome())
        if rejected is not None:      # nothing of it is listed or placed
            _note(MANIFEST_NAME, rejected)
            out["failed"] += 1
    for key in keys:
        runner, outcome = lookup_runner(key)
        if runner is not None:
            out["loaded"] += 1
            with st._lock:
                st._stats["preloaded"] += 1
        else:
            out["failed"] += 1
    obs.count("artifact_preload", out["loaded"])
    obs.record_decision("artifact", "preload", loaded=out["loaded"],
                        failed=out["failed"], path=str(st.path))
    return out
