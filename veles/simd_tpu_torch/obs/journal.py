"""The history axis: a durable append-only event journal.

A copy of ``veles.simd_tpu.obs.journal``, which imports nothing of its
package; the port keeps its own so that it never imports the JAX
package.  Both write the same schema (:data:`SCHEMA`) and the same file
names, so a journal written by either package is read by the other's
:func:`tail`, :func:`cursor`, :func:`read_file` and :func:`read_pack`.

Every other obs axis is a bounded in-process ring and dies with the
process.  The journal survives it: a process-wide append-only JSONL
record of every decision event that flows through
``obs.record_decision`` — breaker transitions, fault/retry/degrade
steps, autotune outcomes, device probes — written line-atomically to
disk so a timeline can be rebuilt after the process that lived it is
gone.

Contract:

* **Off by default.**  Armed by ``$VELES_SIMD_JOURNAL_DIR`` or
  ``obs.configure(journal_dir=...)``; while disarmed, :func:`emit` is
  a single attribute + env check and nothing touches the filesystem.
* **Schema-stamped records.**  Every line is one JSON object carrying
  ``schema`` (:data:`SCHEMA`), a per-process monotonically rising
  ``seq``, BOTH clocks (``t_mono`` for intra-process deltas, ``t_wall``
  for cross-process merge ordering), ``pid``, and the replica identity
  (:func:`set_replica`).  The event payload lives under its own
  ``data`` key, so a payload field can never collide with the writer's
  identity stamp.
* **Line-atomic appends.**  One locked ``write()`` + ``flush()`` of a
  complete ``\\n``-terminated line per record; concurrent dispatch
  threads interleave *lines*, never bytes mid-record.
* **Bounded disk.**  Segments rotate at
  ``$VELES_SIMD_JOURNAL_MAX_BYTES`` (default 4 MiB) and the writer
  prunes its own oldest segments to keep its total under
  ``$VELES_SIMD_JOURNAL_MAX_TOTAL_BYTES`` (default 64 MiB).  A writer
  only ever deletes files it named itself (``journal-<pid>-*``) — a
  shared pack directory is safe across processes.
* **Torn tails are counted, not fatal.**  A process killed mid-write
  leaves at most one torn line; :func:`read_file` / :func:`read_pack`
  recover every parseable record and count the rest (``skipped``).
* **One file per process.**  Each process journals to its own
  ``journal-<pid>-<seq>.jsonl`` files in the shared pack;
  :func:`discover` finds them all.

Write failures (read-only dir, disk full) are *counted drops* — the
journal must never take down the dispatch path it is recording.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time

from veles.simd_tpu_torch.obs._env import getenv

__all__ = [
    "SCHEMA", "JOURNAL_DIR_ENV", "MAX_BYTES_ENV", "MAX_TOTAL_BYTES_ENV",
    "DEFAULT_MAX_BYTES", "DEFAULT_MAX_TOTAL_BYTES", "TAIL_KEEP",
    "JournalWriter",
    "armed", "journal_dir", "configure_dir", "set_replica", "replica",
    "emit", "emit_decision", "cursor", "tail", "stats",
    "prune_foreign",
    "discover", "read_file", "read_pack",
]

SCHEMA = "veles-simd-journal-v1"
JOURNAL_DIR_ENV = "VELES_SIMD_JOURNAL_DIR"
MAX_BYTES_ENV = "VELES_SIMD_JOURNAL_MAX_BYTES"
MAX_TOTAL_BYTES_ENV = "VELES_SIMD_JOURNAL_MAX_TOTAL_BYTES"

# 4 MiB segments: large enough that rotation is rare at decision-event
# rates, small enough that pruning one segment frees meaningful space
DEFAULT_MAX_BYTES = 4 * 1024 * 1024
# 64 MiB per process: days of decision events, bounded like every
# other obs buffer — history that grows without bound is an outage
DEFAULT_MAX_TOTAL_BYTES = 64 * 1024 * 1024

# in-memory tail retained for flight bundles: enough records to tell
# the story right before a crash even after the journal rotated
TAIL_KEEP = 64

_FILE_RE = re.compile(r"^journal-(\d+)-(\d+)\.jsonl$")


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        value = int(raw)
    except ValueError:
        return default
    return value if value > 0 else default


class JournalWriter:
    """One process's journal: the current segment file handle, the
    rotation/prune state, and the in-memory tail.  All appends go
    through one lock; every public method is exception-proof where the
    contract demands it (:meth:`append` counts failures as drops)."""

    def __init__(self, directory: str,
                 max_bytes: int | None = None,
                 max_total_bytes: int | None = None):
        self.dir = str(directory)
        self.max_bytes = int(max_bytes) if max_bytes \
            else _env_int(MAX_BYTES_ENV, DEFAULT_MAX_BYTES)
        self.max_total_bytes = int(max_total_bytes) if max_total_bytes \
            else _env_int(MAX_TOTAL_BYTES_ENV, DEFAULT_MAX_TOTAL_BYTES)
        self.pid = os.getpid()
        self._lock = threading.Lock()
        self._fh = None
        self._size = 0
        self._seg = self._next_segment()
        self._seq = 0
        self.records = 0
        self.dropped = 0
        self.rotations = 0
        self.pruned = 0
        self.last_t_mono: float | None = None
        self._tail: list = []

    # -- naming ------------------------------------------------------------

    def _next_segment(self) -> int:
        """First segment number: one past anything this pid already
        wrote (a reconfigured writer must never clobber its own past)."""
        top = 0
        try:
            for name in os.listdir(self.dir):
                m = _FILE_RE.match(name)
                if m and int(m.group(1)) == self.pid:
                    top = max(top, int(m.group(2)))
        except OSError:
            pass
        return top + 1

    def _segment_path(self, seg: int) -> str:
        return os.path.join(self.dir, "journal-%d-%06d.jsonl"
                            % (self.pid, seg))

    @property
    def current_file(self) -> str:
        return self._segment_path(self._seg)

    # -- writes ------------------------------------------------------------

    def append(self, record: dict) -> bool:
        """Stamp and append one record as one line; returns False on a
        counted drop (write failure).  Never raises."""
        try:
            with self._lock:
                self._seq += 1
                t_mono = time.monotonic()
                stamped = {"schema": SCHEMA, "seq": self._seq,
                           "t_mono": t_mono, "t_wall": time.time(),
                           "pid": self.pid, "replica": replica()}
                stamped.update(record)
                line = json.dumps(stamped, separators=(",", ":"),
                                  default=str) + "\n"
                data = line.encode("utf-8")
                if self._fh is None \
                        or self._size + len(data) > self.max_bytes:
                    self._rotate_locked()
                self._fh.write(data)
                self._fh.flush()
                self._size += len(data)
                self.records += 1
                self.last_t_mono = t_mono
                self._tail.append(stamped)
                if len(self._tail) > TAIL_KEEP:
                    del self._tail[0]
                return True
        except Exception:  # noqa: BLE001 — the journal never takes
            with self._lock:  # down the path it records
                self.dropped += 1
            return False

    def _rotate_locked(self) -> None:
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._seg += 1
            self.rotations += 1
        os.makedirs(self.dir, exist_ok=True)
        self._fh = open(self.current_file, "ab")
        self._size = self._fh.tell()
        self._prune_locked()

    def _prune_locked(self) -> None:
        """Keep THIS pid's total bytes under the budget by unlinking
        its oldest segments (never the current one).  Other replicas'
        files in a shared pack are never touched."""
        own = []
        try:
            for name in os.listdir(self.dir):
                m = _FILE_RE.match(name)
                if m and int(m.group(1)) == self.pid:
                    path = os.path.join(self.dir, name)
                    try:
                        own.append((int(m.group(2)), path,
                                    os.path.getsize(path)))
                    except OSError:
                        continue
        except OSError:
            return
        own.sort()
        total = sum(size for _, _, size in own)
        for seg, path, size in own:
            if total <= self.max_total_bytes or seg >= self._seg:
                break
            try:
                os.unlink(path)
                total -= size
                self.pruned += 1
            except OSError:
                break

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None

    # -- reads -------------------------------------------------------------

    def cursor(self) -> dict:
        """Where the journal is NOW: the current segment file, the byte
        offset within it, and the per-process record count — embedded
        in flight bundles and incident records so a postmortem can seek
        straight to the moment."""
        with self._lock:
            return {"file": os.path.basename(self.current_file),
                    "dir": self.dir, "offset": self._size,
                    "segment": self._seg, "records": self.records}

    def tail(self, n: int = TAIL_KEEP) -> list:
        """The last ``n`` stamped records (newest last) from memory —
        what a flight bundle embeds so it stays self-diagnosing even
        after the on-disk journal rotates past the incident."""
        with self._lock:
            return [dict(r) for r in self._tail[-int(n):]]

    def stats(self) -> dict:
        with self._lock:
            return {"dir": self.dir, "records": self.records,
                    "dropped": self.dropped,
                    "rotations": self.rotations, "pruned": self.pruned,
                    "segment": self._seg, "bytes": self._size,
                    "max_bytes": self.max_bytes,
                    "max_total_bytes": self.max_total_bytes,
                    "last_t_mono": self.last_t_mono}


# -- the process-wide writer (the facade's funnel) ---------------------------

_lock = threading.Lock()
_configured_dir: str | None = None
_replica: str | None = None
_writer: JournalWriter | None = None
_pruned_foreign = 0


def journal_dir() -> str | None:
    """Where the journal goes: the configured dir, else
    ``$VELES_SIMD_JOURNAL_DIR``, else None (disarmed).  Read through
    the cheap :func:`getenv`: ``armed()`` runs on every decision
    event."""
    d = _configured_dir
    if d is not None:
        return d or None
    return (getenv(JOURNAL_DIR_ENV) or "").strip() or None


def armed() -> bool:
    """Is the journal writing?  One attribute + env check — the
    disarmed cost on every decision event."""
    return journal_dir() is not None


def configure_dir(path: str | None) -> None:
    """Runtime override of ``$VELES_SIMD_JOURNAL_DIR`` (pass ``""`` to
    restore the environment lookup, None is the same).  Wired to
    ``obs.configure(journal_dir=...)``.  Changing the destination
    closes the current writer; the next :func:`emit` reopens in the
    new pack."""
    global _configured_dir, _writer
    with _lock:
        _configured_dir = str(path) if path is not None else None
        if _writer is not None:
            _writer.close()
            _writer = None


def set_replica(name: str | None) -> None:
    """Stamp this process's replica identity into every subsequent
    record (subprocess replicas call this with their spec name; the
    router process usually leaves it None)."""
    global _replica
    _replica = str(name) if name else None


def replica() -> str | None:
    return _replica


def _ensure_writer() -> JournalWriter | None:
    global _writer
    d = journal_dir()
    if d is None:
        return None
    w = _writer
    if w is not None and w.dir == d:
        return w
    with _lock:
        if _writer is None or _writer.dir != d:
            if _writer is not None:
                _writer.close()
            _writer = JournalWriter(d)
        return _writer


def emit(kind: str, fields: dict | None = None, **top) -> bool:
    """Append one ``kind``-tagged record when armed (no-op returning
    False otherwise).  The writer stamps schema/seq/clocks/pid/replica;
    ``fields`` is the JSON-native payload (landing under ``data``);
    ``top`` adds promoted top-level keys (``op``/``decision``).  Never
    raises."""
    try:
        w = _ensure_writer()
        if w is None:
            return False
        rec = {"kind": str(kind)}
        rec.update(top)
        rec["data"] = dict(fields) if fields else {}
        return w.append(rec)
    except Exception:  # noqa: BLE001
        return False


def emit_decision(op: str, decision: str, fields: dict) -> bool:
    """The ``obs.record_decision`` tap: one ``decision`` record per
    event.  Every breaker transition, replica lifecycle edge, SLO
    breach, fault/retry/degrade step, autotune/artifact outcome, and
    chaos phase already flows through that funnel — so it flows
    through here."""
    return emit("decision", fields, op=str(op), decision=str(decision))


def cursor() -> dict | None:
    """The live writer's :meth:`JournalWriter.cursor` (None while
    disarmed or before the first record)."""
    w = _writer
    return w.cursor() if w is not None else None


def tail(n: int = TAIL_KEEP) -> list:
    """The live writer's in-memory tail (empty while disarmed)."""
    w = _writer
    return w.tail(n) if w is not None else []


def stats(now: float | None = None) -> dict:
    """Journal health for ``obs.snapshot()`` and the signals bundle:
    armed flag, record/drop/rotation counts, and ``lag_s`` — seconds
    since the last record landed (None before the first)."""
    w = _writer
    out = {"armed": armed(), "dir": journal_dir(),
           "records": 0, "dropped": 0, "rotations": 0, "pruned": 0,
           "pruned_foreign": _pruned_foreign, "lag_s": None}
    if w is None:
        return out
    s = w.stats()
    out.update({"records": s["records"], "dropped": s["dropped"],
                "rotations": s["rotations"], "pruned": s["pruned"],
                "bytes": s["bytes"], "segment": s["segment"]})
    if s["last_t_mono"] is not None:
        t = now if now is not None else time.monotonic()
        out["lag_s"] = max(0.0, t - s["last_t_mono"])
    return out


def _pid_alive(pid: int) -> bool:
    """Liveness probe without touching the process: signal 0.  A pid we
    cannot signal for *permission* reasons exists (someone else's
    process in a shared pack) — treat it as alive; only a confirmed
    ``ProcessLookupError`` counts as dead."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except (PermissionError, OSError):
        return True
    return True


def prune_foreign(directory: str | None = None,
                  max_total_bytes: int | None = None,
                  live_pids=()) -> int:
    """Reclaim dead-pid segments from a shared journal pack.

    Per-writer rotation prunes own-pid files only, so segments from
    killed subprocess replicas strand on disk forever.  The group
    owner (the fleet collector thread) calls this to delete dead
    writers' segments oldest-first (by mtime) until the *pack* total
    is back under the ``$VELES_SIMD_JOURNAL_MAX_TOTAL_BYTES`` budget.
    Never touches this process's own files, any pid in ``live_pids``,
    or any pid that answers a signal-0 probe.  Returns the number of
    files unlinked (also counted in ``stats()['pruned_foreign']``).
    Never raises."""
    global _pruned_foreign
    try:
        d = directory if directory is not None else journal_dir()
        if d is None:
            return 0
        budget = int(max_total_bytes) if max_total_bytes \
            else _env_int(MAX_TOTAL_BYTES_ENV, DEFAULT_MAX_TOTAL_BYTES)
        protected = {os.getpid()}
        protected.update(int(p) for p in live_pids)
        entries = []  # (mtime, path, size, pid)
        total = 0
        try:
            names = os.listdir(d)
        except OSError:
            return 0
        for name in names:
            m = _FILE_RE.match(name)
            if not m:
                continue
            path = os.path.join(d, name)
            try:
                st = os.stat(path)
            except OSError:
                continue
            total += st.st_size
            pid = int(m.group(1))
            if pid in protected:
                continue
            entries.append((st.st_mtime, path, st.st_size, pid))
        if total <= budget:
            return 0
        alive_cache: dict = {}
        entries.sort()
        pruned = 0
        for _, path, size, pid in entries:
            if total <= budget:
                break
            if pid not in alive_cache:
                alive_cache[pid] = _pid_alive(pid)
            if alive_cache[pid]:
                continue
            try:
                os.unlink(path)
            except OSError:
                continue
            total -= size
            pruned += 1
        if pruned:
            with _lock:
                _pruned_foreign += pruned
        return pruned
    except Exception:  # noqa: BLE001 — reclamation never takes down
        return 0  # the collector thread that calls it


def _reset_for_tests() -> None:
    """Close and forget the process writer (files stay on disk)."""
    global _writer, _replica, _pruned_foreign
    with _lock:
        if _writer is not None:
            _writer.close()
            _writer = None
        _pruned_foreign = 0
    _replica = None


# -- the reader (offline reconstruction) -------------------------------------

def discover(directory: str) -> list:
    """Journal files in a pack directory, sorted ``(pid, segment)`` —
    one process's segments stay contiguous, different replicas' files
    interleave deterministically."""
    found = []
    try:
        for name in os.listdir(directory):
            m = _FILE_RE.match(name)
            if m:
                found.append((int(m.group(1)), int(m.group(2)),
                              os.path.join(directory, name)))
    except OSError:
        return []
    found.sort()
    return [path for _, _, path in found]


def read_file(path: str) -> tuple:
    """``(records, skipped)`` from one journal file.  Corrupt lines and
    the torn tail a killed replica leaves behind are *counted*, never
    fatal — every parseable record is recovered (the TuneCache
    discipline).  A complete-JSON final line without its newline still
    counts as a record (the write made it; only the flush of the
    newline boundary is in doubt on some filesystems)."""
    records, skipped = [], 0
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return [], 1
    for raw in data.split(b"\n"):
        raw = raw.strip()
        if not raw:
            continue
        try:
            rec = json.loads(raw.decode("utf-8", errors="strict"))
        except (ValueError, UnicodeDecodeError):
            skipped += 1
            continue
        if isinstance(rec, dict):
            records.append(rec)
        else:
            skipped += 1
    return records, skipped


def read_pack(directory: str) -> tuple:
    """``(records, skipped)`` across every journal file in the pack,
    merged into one fleet timeline ordered by wall clock (the only
    clock shared across processes; ties break on ``(pid, seq)``).
    Each record gains a ``_file`` provenance key."""
    merged, skipped = [], 0
    for path in discover(directory):
        recs, skip = read_file(path)
        skipped += skip
        base = os.path.basename(path)
        for r in recs:
            r["_file"] = base
            merged.append(r)
    merged.sort(key=lambda r: (r.get("t_wall", 0.0),
                               r.get("pid", 0), r.get("seq", 0)))
    return merged, skipped
