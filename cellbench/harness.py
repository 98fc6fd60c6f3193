"""The benchmark's machinery: one cell, one seed, one run.

A cell is found by name.  ``BENCHMARK.json`` at the checkout's root
names its configuration, its chips and the metrics it reports;
``cellbench/configs/<config>.json`` holds the configuration and names
the entry that drives the program (``cellbench/entries/<entry>.py``);
``cellbench/workloads/<cell>.json`` holds the traffic and the limits of
the output check; ``cellbench/reference/<config>.py`` is the plain
reference; ``cellbench/metrics/<metric>.py`` reads one metric.  A new
cell, configuration or metric is a new file, and nothing here changes.

One run: the operands are made on the device from the seed (a pool of
distinct input batches and the fixed operands), every call is warmed
up, then one caller calls the entry in a closed loop for the window's
seconds, waiting for the card after every call, rotating through the
pool.  A sample of the calls, drawn from the seed, keeps its outputs;
once the window has closed and the program is released, the reference
recomputes those calls from the same operands and the widest relative
gap decides ``correct``.  With ``trace`` the window runs under CUPTI
(``cellbench/devtrace.py``) and the per-layer metrics are read.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import math
import os
import random
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from cellbench import devtrace

ROOT = Path(__file__).resolve().parents[1]

# imported in the run's process, these mean the JAX package runs there
FORBIDDEN = (("jax",), ("jaxlib",), ("flax",), ("veles", "simd_tpu"))

# the host spans that tile a window, in the order they run
SPANS = ("call", "sync", "loop")


class SpecError(ValueError):
    """A cell, configuration or metric that the files do not define."""


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` and the files it names."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    root: Path

    @property
    def params(self) -> dict:
        """The configuration's settings, then the traffic's."""
        return {**self.config["settings"], **self.traffic["shape"]}

    def path(self, *parts) -> Path:
        return self.root.joinpath("cellbench", *parts)


def set_environment(root: Path = ROOT) -> None:
    """The program's defaults whatever the caller's environment holds
    (no ``VELES_SIMD_*`` knob: autotune off, telemetry off), and every
    build cache at a fixed path inside the checkout."""
    for name in [k for k in os.environ if k.startswith("VELES_SIMD_")]:
        del os.environ[name]
    cache = root / "build" / "cellbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def load_program(root: Path = ROOT) -> str | None:
    """Import the program from the checkout and keep its kernels' build
    in the checkout's ``build/simd_tpu_torch``; the reason it cannot,
    or None."""
    try:
        import veles.simd_tpu_torch as program
        from veles.simd_tpu_torch.ops import cuda_kernels
    except ImportError as e:
        return f"the program is not in this checkout: {e}"
    if root not in Path(program.__file__).resolve().parents:
        return (f"the program was imported from {program.__file__}, "
                f"outside {root}")
    cuda_kernels.set_build_root(root / "build" / "simd_tpu_torch")
    return None


def _read_json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise SpecError(f"{path} does not exist") from None


def _reported(metrics: list, workload: str) -> list:
    return [m for m in metrics
            if "workloads" not in m or workload in m["workloads"]]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``."""
    bench = _read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise SpecError(f"workload {name!r} names no configuration")
    config = _read_json(root / configs[w["config"]]["file"])
    traffic = _read_json(root / "cellbench" / "workloads" / f"{name}.json")
    if traffic.get("config") != w["config"]:
        raise SpecError(f"{name}.json is not of configuration "
                        f"{w['config']!r}")
    return Cell(name, int(w["chips"]), w["config"], config, traffic,
                _reported(bench["end_to_end"], name),
                _reported(bench["per_layer"], name), root)


def load_module(path: Path):
    """The Python file ``path`` as a module of its own."""
    if not path.is_file():
        raise SpecError(f"{path} does not exist")
    tag = re.sub(r"\W", "_", f"{path.parent.name}_{path.stem}")
    spec = importlib.util.spec_from_file_location(f"cellbench._{tag}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Modules of ``sys.modules`` that are JAX or the JAX package,
    compared by whole dotted parts (``veles.simd_tpu_torch`` is not
    ``veles.simd_tpu``)."""
    found = []
    for mod in list(sys.modules):
        parts = tuple(mod.split("."))
        if any(parts[:len(f)] == f for f in FORBIDDEN):
            found.append(mod)
    return sorted(found)


def make_operands(spec: dict, params: dict, seed: int, pool: int,
                  device) -> tuple[list[dict], dict]:
    """``(slots, fixed)``: ``pool`` dicts of the pooled operands, each a
    distinct batch, and one dict of the fixed operands, all standard
    normal float32 on ``device``, drawn in name order from a generator
    on that device seeded with ``seed``: the same seed, the same
    operands."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    slots = [{} for _ in range(pool)]
    fixed = {}
    for name in sorted(spec):
        shape = [int(params[k]) for k in spec[name]["shape"]]
        if spec[name]["pool"]:
            batch = torch.randn([pool] + shape, generator=gen,
                                device=device)
            for slot, part in zip(slots, batch.unbind(0)):
                slot[name] = part
        else:
            fixed[name] = torch.randn(shape, generator=gen, device=device)
    return slots, fixed


def as_list(out) -> list:
    """The output tensors of one call, in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    return list(out)


class Reservoir:
    """A uniform sample of ``k`` calls' outputs over however many calls
    a window makes, drawn from the seed (algorithm R)."""

    def __init__(self, seed: int, k: int):
        self.rng = random.Random(int(seed))
        self.k = k
        self.kept: list = []          # (call index, outputs)

    def offer(self, i: int, out) -> None:
        if i < self.k:
            self.kept.append((i, out))
            return
        j = self.rng.randrange(i + 1)
        if j < self.k:
            self.kept[j] = (i, out)


@dataclasses.dataclass
class Window:
    """Host instants (``perf_counter_ns``) of every call: its start
    ``a``, its return ``b`` and the end of the wait for the card ``c``.
    ``call`` is ``[a, b)``, ``sync`` ``[b, c)``, ``loop`` ``[c, next
    a)``."""

    a: np.ndarray
    b: np.ndarray
    c: np.ndarray

    @property
    def calls(self) -> int:
        return len(self.a)

    @property
    def seconds(self) -> float:
        return (self.c[-1] - self.a[0]) / 1e9


def closed_loop(call, slots, seconds: float, sync, reservoir) -> Window:
    """Call ``call`` on the pool's slots in turn, one caller, each call
    waited for, until ``seconds`` have passed since the first."""
    clock = time.perf_counter_ns
    a_s, b_s, c_s = [], [], []
    n_slots = len(slots)
    i = 0
    deadline = clock() + int(seconds * 1e9)
    while True:
        slot = slots[i % n_slots]
        a = clock()
        out = call(**slot)
        b = clock()
        sync()
        c = clock()
        a_s.append(a)
        b_s.append(b)
        c_s.append(c)
        reservoir.offer(i, out)
        out = None
        i += 1
        if c >= deadline:
            break
    return Window(np.array(a_s, np.int64), np.array(b_s, np.int64),
                  np.array(c_s, np.int64))


def _merge(intervals: np.ndarray) -> np.ndarray:
    """The union of ``[start, end]`` rows as disjoint sorted rows."""
    if len(intervals) == 0:
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    idx = np.flatnonzero(new)
    last = np.append(idx[1:] - 1, len(iv) - 1)
    return np.stack([starts, ends[last]], axis=1)


def attribute(gaps: np.ndarray, bounds: np.ndarray,
              labels: np.ndarray, n_labels: int) -> np.ndarray:
    """Time of the ``gaps`` rows that falls in segments of each label:
    segment ``j`` is ``[bounds[j], bounds[j + 1])`` with label
    ``labels[j]``."""
    seg = np.diff(bounds).astype(np.float64)
    out = np.zeros(n_labels)
    for lab in range(n_labels):
        cum = np.concatenate([[0.0], np.cumsum(np.where(labels == lab,
                                                        seg, 0.0))])

        def upto(t):
            j = np.clip(np.searchsorted(bounds, t, side="right") - 1, 0,
                        len(seg) - 1)
            part = np.clip(np.minimum(t, bounds[j + 1]) - bounds[j], 0,
                           None)
            return cum[j] + np.where(labels[j] == lab, part, 0.0)

        out[lab] = float(np.sum(upto(gaps[:, 1]) - upto(gaps[:, 0])))
    return out


@dataclasses.dataclass
class Readings:
    """What the metric readers read: the window's host instants, the
    set-up time, the program's launch counter, the least work of a call
    and, in a traced run, the device's records with the map from host
    instants onto their clock."""

    window: Window
    setup_s: float
    samples_per_call: int
    launches: int
    work: tuple
    records: list | None = None
    to_device: object = None     # host ns -> CUPTI ns since ``origin``
    origin: int = 0

    @property
    def calls(self) -> int:
        return self.window.calls

    @functools.cached_property
    def stamps(self) -> np.ndarray:
        """``[start, end]`` of every record, ns since ``origin``."""
        return np.array([(r.start - self.origin, r.end - self.origin)
                         for r in self.records],
                        np.float64).reshape(-1, 2)

    def device_window(self) -> tuple[float, float]:
        """The window ``[first call's start, last call's end]`` on
        CUPTI's clock, ns since ``origin``."""
        return (float(self.to_device(self.window.a[0])),
                float(self.to_device(self.window.c[-1])))

    @functools.cached_property
    def busy(self) -> np.ndarray:
        """Disjoint intervals in which the device ran a kernel, copy or
        memset, clipped to the window."""
        lo, hi = self.device_window()
        iv = np.clip(self.stamps, lo, hi)
        return _merge(iv[iv[:, 1] > iv[:, 0]])

    def busy_s(self) -> float:
        return float(np.sum(self.busy[:, 1] - self.busy[:, 0])) / 1e9

    def idle_by_span(self) -> dict:
        """Idle device seconds by the host span open meanwhile."""
        lo, hi = self.device_window()
        edges = np.concatenate([[lo], self.busy.ravel(), [hi]])
        edges = edges.reshape(-1, 2)
        gaps = edges[edges[:, 1] > edges[:, 0]]
        w = self.window
        bounds = self.to_device(np.stack([w.a, w.b, w.c], axis=1).ravel())
        labels = np.tile(np.arange(len(SPANS)), w.calls)[:-1]
        idle = attribute(gaps, bounds, labels, len(SPANS))
        return {name: float(s) / 1e9 for name, s in zip(SPANS, idle)}

    def device_ops(self) -> dict:
        """Device seconds by kernel, copy or memset name."""
        by: dict[str, int] = {}
        for r in self.records:
            by[r.name] = by.get(r.name, 0) + (r.end - r.start)
        return {k: v / 1e9 for k, v in by.items()}


def _anchor() -> tuple[int, int]:
    """A host instant (``perf_counter_ns``) and CUPTI's clock at it."""
    t0 = time.perf_counter_ns()
    d = devtrace.timestamp()
    t1 = time.perf_counter_ns()
    return (t0 + t1) // 2, d


def host_to_device(first, last):
    """The linear map from host ns onto CUPTI ns since ``first``'s
    stamp, through two ``(host, cupti)`` anchors."""
    (p0, d0), (p1, d1) = first, last
    scale = (d1 - d0) / (p1 - p0) if p1 != p0 else 1.0
    return lambda t: (np.asarray(t, np.int64) - p0).astype(
        np.float64) * scale


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """``max |got - want| / max |want|``; infinite for a wrong shape or
    a value that is not finite."""
    if tuple(got.shape) != tuple(want.shape):
        return math.inf
    scale = float(want.abs().max())
    diff = float((got.to(torch.float64) - want).abs().max())
    if not math.isfinite(diff) or scale == 0.0:
        return math.inf
    return diff / scale


def check(pairs, slots, fixed, reference, params) -> dict:
    """The numbers compared: the widest relative gap between outputs
    and the reference, over every output tensor (each against its own
    largest reference value) of every ``(slot, outputs)`` pair, and how
    many outputs were compared.  The reference runs once a slot."""
    worst, compared = 0.0, 0
    by_slot: dict[int, list] = {}
    for s, out in pairs:
        by_slot.setdefault(s, []).append(out)
    for s, outs in sorted(by_slot.items()):
        want = reference.expected(params, **slots[s], fixed=fixed)
        for out in outs:
            got = as_list(out)
            if len(got) != len(want):
                worst = math.inf
            for g, w in zip(got, want):
                worst = max(worst, rel_err(g, w))
            compared += 1
        want = None
    return {"max_rel_err": worst, "calls_compared": compared}


_SMI = ("power.limit", "clocks.sm", "clocks.mem", "temperature.gpu",
        "power.draw")


def card_facts() -> dict:
    """The card's power limit, its clocks, temperature and draw as the
    window closes, and the software it runs on."""
    facts = {"torch": torch.__version__, "cuda": torch.version.cuda}
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(_SMI)}",
             "--format=csv,noheader", "--id=0"], capture_output=True,
            text=True, timeout=20, check=True).stdout.strip()
        facts.update(zip(_SMI, (v.strip() for v in out.split(","))))
    except (OSError, subprocess.SubprocessError):
        facts["power.limit"] = "not read"
    return facts


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, wrap=None, params=None, control=False,
        phases=None) -> dict:
    """One run of ``cell``: its result line, whose last key ``check``
    holds each number compared beside its limit.  ``t_start`` is the
    process's start on ``time.perf_counter``; ``phases`` holds the
    seconds at which set-up's earlier parts ended.  For tests and for
    setting limits: ``wrap`` replaces the entry by ``wrap(entry)``,
    ``params`` overrides the cell's sizes, and ``control`` adds the
    control's numbers (the reference one precision lower, in the
    program's place) under ``control``."""
    cuda = torch.device(device).type == "cuda"
    params = {**cell.params, **(params or {})}
    metrics_spec = cell.per_layer if trace else cell.end_to_end
    entry_mod = load_module(cell.path("entries",
                                      f"{cell.config['entry']}.py"))
    reference = load_module(cell.path("reference",
                                      f"{cell.config_name}.py"))
    readers = {m["name"]: load_module(cell.path("metrics",
                                                f"{m['name']}.py"))
               for m in metrics_spec}
    sample = int(cell.traffic["check"]["sample"])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    from veles.simd_tpu_torch.ops import cuda_kernels

    def launches():
        return sum(cuda_kernels.LAUNCHES.values())

    # set-up's parts, seconds since the process started
    phases = {**(phases or {}), "imports": time.perf_counter() - t_start}
    slots, fixed = make_operands(entry_mod.OPERANDS, params, seed,
                                 int(cell.traffic["pool"]), device)
    sync()
    phases["operands"] = time.perf_counter() - t_start
    entry = entry_mod.Entry(params, fixed)
    call = entry if wrap is None else wrap(entry)
    # warm every slot's call, and let the allocator hold as many
    # outputs at once as the sample will
    held = [call(**slots[i % len(slots)])
            for i in range(max(len(slots), sample + 2))]
    sync()
    held = None
    phases["warm_up"] = time.perf_counter() - t_start
    reservoir = Reservoir(seed, sample)
    if trace:
        devtrace.trace(lambda: call(**slots[0]))     # starts CUPTI
    before = launches()
    records = to_device = None
    origin = 0
    if trace:
        first = _anchor()
        setup_s = time.perf_counter() - t_start
        records, window = devtrace.trace(
            lambda: closed_loop(call, slots, seconds, sync, reservoir))
        to_device = host_to_device(first, _anchor())
        origin = first[1]
    else:
        setup_s = time.perf_counter() - t_start
        window = closed_loop(call, slots, seconds, sync, reservoir)
    made = launches() - before
    card = card_facts() if cuda else {}
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    entry.close()
    entry = call = None
    readings = Readings(window, setup_s, entry_mod.samples(params), made,
                        entry_mod.least_work(params), records, to_device,
                        origin)
    metrics = {}
    for m in metrics_spec:
        value = readers[m["name"]].read(readings)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    pairs = [(i % len(slots), out) for i, out in reservoir.kept]
    used = sorted({s for s, _ in pairs})
    reservoir = None
    numbers = check(pairs, slots, fixed, reference, params)
    pairs = None
    limits = cell.traffic["check"]["limits"]
    compared = {k: {"value": numbers[k], "limit": limits.get(k)}
                for k in limits}
    correct = bool(compared) and all(
        v["limit"] is not None and v["value"] <= v["limit"]
        for v in compared.values())
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips if cuda else 0,
           "memory_peak_bytes": int(memory_peak)}
    line = {"correct": correct, "attempted": window.calls, "failed": 0,
            "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = readings.busy_s()
        dev["window_s"] = window.seconds
        ops = sorted(readings.device_ops().items(), key=lambda kv: -kv[1])
        gaps = sorted(readings.idle_by_span().items(),
                      key=lambda kv: -kv[1])
        line["breakdown"] = {
            "device_ops": [[k[:160], v] for k, v in ops[:10]],
            "idle_gaps": [[k, v] for k, v in gaps[:10]]}
    line["card"] = card
    line["setup_phases_s"] = phases
    line["calls_compared"] = numbers["calls_compared"]
    if control:
        line["control"] = check(
            [(s, reference.expected(params, **slots[s], fixed=fixed,
                                    control=True)) for s in used],
            slots, fixed, reference, params)
    line["check"] = compared
    return line
