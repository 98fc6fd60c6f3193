"""The pipeline compiler: an op chain run as ONE step per block.

The port of ``veles.simd_tpu.pipeline.compiler``.  :class:`Pipeline`
holds a declarative stage chain (:mod:`veles.simd_tpu_torch.pipeline.
stages`); :meth:`Pipeline.compile` validates the geometry once, resolves
every routed stage's kernel through the ``routing.family`` tables (tune
classes stamped :func:`~veles.simd_tpu_torch.runtime.routing.
pipeline_tune_geom`), puts every stage constant on the configured
device, and builds one block step ``(block, state) -> (out, state')``
with every stage's carried state threaded through it as a tuple.

Where the JAX package jits that step once per geometry, the port:

* **on the card** captures it as one ``torch.cuda.CUDAGraph`` per batch
  shape, on the first :meth:`CompiledPipeline.process` of that shape,
  after warm-up runs on a side stream (which also let cuFFT and cuDNN
  choose their plans).  The graph reads static input and state
  buffers; each later block copies its input and state into them, calls
  ``replay()`` once and returns copies of the output and state (the
  graph's own buffers are overwritten by the next replay), all under
  the graph's lock, so threads may share one compiled pipeline.  A
  capture that fails raises :class:`PipelineCaptureError`, naming the
  stage; nothing falls back to eager replay;
* **on the CPU** runs the step eagerly once per block.

:meth:`CompiledPipeline.compile_cache_size` counts the prepared
geometries (graphs on the card, eager plans on the CPU);
``obs.caches()["pipeline_graphs"]`` lists the graphs of every compiled
pipeline.  Side effects inside the step (decision events, launch
counters, spans) run once, at capture: the per-block accounting — the
``pipeline.dispatch`` span, the fault policy, the breaker — lives in
:meth:`CompiledPipeline.process`, outside the graph.

The step dispatches under
:func:`veles.simd_tpu_torch.runtime.faults.breaker_guarded` at the
``pipeline.dispatch`` site with a per-pipeline-class breaker keyed
``(name, block_len)``: a transient device fault retries; a block that
came from the host then degrades to the stage-by-stage NumPy oracle
twin (identical streaming semantics, so the stream continues with exact
state), while a block already on the card gets no oracle — it retries,
then re-raises.

Parity contract (``tests/test_torch_pipeline.py``): for any block
decomposition, :meth:`CompiledPipeline.stream` equals
:meth:`CompiledPipeline.oracle` on the whole signal, and the JAX
package's ``stream`` on the same input, and a stream may cross between
the two packages at a block boundary.

Usage::

    from veles.simd_tpu_torch import pipeline as pl

    chain = pl.Pipeline([pl.resample_poly(2, 1), pl.sosfilt(sos),
                         pl.stft(256, 64), pl.power()],
                        name="sensor")
    cp = chain.compile(block_len=1024)
    state = cp.init_state()
    for block in blocks:
        out, state = cp.process(block, state)   # ONE graph replay each
"""

from __future__ import annotations

import copy
import threading
import weakref

import numpy as np
import torch

from veles.simd_tpu_torch import obs
from veles.simd_tpu_torch.pipeline.stages import MODES, Stage
from veles.simd_tpu_torch.runtime import faults, routing
from veles.simd_tpu_torch.utils import platform as _platform

__all__ = ["Pipeline", "CompiledPipeline", "PIPELINE_SITE"]

# the fused step's fault-policy site: VELES_SIMD_FAULT_PLAN entries
# (`pipeline.dispatch:device_lost:1`) exercise retry/degrade on the CPU
PIPELINE_SITE = "pipeline.dispatch"

# eager runs of the step on a side stream before its capture: they let
# cuFFT, cuBLAS and cuDNN pick their plans and workspaces, and fill the
# routes' device constant caches, outside the graph
GRAPH_WARMUP_RUNS = 3


class PipelineCaptureError(RuntimeError):
    """The card refused to capture a pipeline's step as a CUDA graph.
    ``stage`` names the stage that was running (``"capture_end"`` when
    the capture failed as it closed)."""

    def __init__(self, pipeline: str, stage: str, exc: BaseException):
        super().__init__(
            f"pipeline {pipeline!r}: CUDA graph capture failed in stage "
            f"{stage!r}: {type(exc).__name__}: {exc}")
        self.pipeline = pipeline
        self.stage = stage


def _tree_map(fn, tree):
    """Structure-preserving map over the nested tuple/list state."""
    if isinstance(tree, (tuple, list)):
        return tuple(_tree_map(fn, t) for t in tree)
    return fn(tree)


def _tree_leaves(tree, out):
    if isinstance(tree, (tuple, list)):
        for t in tree:
            _tree_leaves(t, out)
    else:
        out.append(tree)
    return out


def _cast_out(leaf):
    """Oracle float64/complex128 outputs -> the device dtypes, so a
    degraded block is shape- and dtype-compatible with the fused ones."""
    a = np.asarray(leaf)
    if a.dtype == np.float64:
        return a.astype(np.float32)
    if a.dtype == np.complex128:
        return a.astype(np.complex64)
    return a


_host = _platform.to_host


# every compiled pipeline, for the obs.caches() provider
_LIVE = weakref.WeakSet()
_live_lock = threading.Lock()


def _graphs_info() -> dict:
    with _live_lock:
        live = list(_LIVE)
    graphs = sum(len(cp._graphs) for cp in live)
    return {"size": graphs, "capacity": None, "pipelines": len(live),
            "hits": sum(g.replays for cp in live
                        for g in list(cp._graphs.values())),
            "misses": graphs, "evictions": 0}


obs.register_cache("pipeline_graphs", _graphs_info)


class _GraphStep:
    """One batch shape's captured step: static input and state buffers,
    the graph, and its output buffers.  ``lock`` holds one block's
    copy-in, replay and copy-out together: two threads on one
    pipeline share these buffers."""

    def __init__(self, run_stages, x, states, pipeline: str):
        self.lock = threading.Lock()
        self.replays = 0
        self.x = x.clone()
        self.states = _tree_map(lambda t: t.clone(), states)
        side = torch.cuda.Stream(device=x.device)
        side.wait_stream(torch.cuda.current_stream(x.device))
        with torch.cuda.stream(side):
            for _ in range(GRAPH_WARMUP_RUNS):
                run_stages(self.x, self.states)
        torch.cuda.current_stream(x.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        where = {"stage": "capture_end"}
        try:
            with torch.cuda.graph(self.graph):
                self.out, self.new_states = run_stages(self.x, self.states,
                                                       where)
                where["stage"] = "capture_end"
        except Exception as e:  # noqa: BLE001 — typed, never eager
            raise PipelineCaptureError(pipeline, where["stage"], e) from e

    def run(self, x, states):
        with self.lock:
            self.x.copy_(x)
            for dst, src in zip(_tree_leaves(self.states, []),
                                _tree_leaves(states, [])):
                dst.copy_(src)
            self.graph.replay()
            self.replays += 1
            # the graph's buffers belong to the next replay: hand out
            # copies
            return (_tree_map(lambda t: t.clone(), self.out),
                    _tree_map(lambda t: t.clone(), self.new_states))


class Pipeline:
    """A declarative op chain: ordered :class:`~veles.simd_tpu_torch.\
pipeline.stages.Stage` descriptors, not yet bound to a block size.
    :meth:`compile` produces the runnable :class:`CompiledPipeline`."""

    def __init__(self, stages, name: str = "pipeline"):
        stages = list(stages)
        if not stages:
            raise ValueError("a pipeline needs at least one stage")
        for st in stages:
            if not isinstance(st, Stage):
                raise TypeError(f"not a pipeline stage: {st!r}")
        for st in stages[:-1]:
            if st.terminal:
                raise ValueError(
                    f"terminal stage {st.name!r} must come last")
        names = [st.name for st in stages]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate stage names: {names}")
        self.stages = stages
        self.name = str(name)

    def compile(self, block_len: int, name: str | None = None
                ) -> "CompiledPipeline":
        """Validate the chain against ``block_len``, resolve every
        routed stage's kernel, place the constants and build the
        step."""
        return CompiledPipeline(self, int(block_len),
                                name=name or self.name)


class CompiledPipeline:
    """One chain bound to one block size on the configured device: a
    single step per block (one CUDA-graph replay on the card) plus the
    stage-by-stage oracle twin (see the module docstring)."""

    def __init__(self, pipeline: Pipeline, block_len: int,
                 name: str):
        if block_len < 1:
            raise ValueError("block_len must be positive")
        self.name = str(name)
        self.block_len = int(block_len)
        # PRIVATE stage copies: plan()/resolve()/place() write geometry,
        # routes and device constants into the stage objects, and a
        # Pipeline may be compiled at several block sizes
        self._stages = copy.deepcopy(pipeline.stages)
        block, mode = self.block_len, "samples"
        self._links = []
        for st in self._stages:
            block, mode = st.plan(block, mode)
            if mode not in MODES:
                raise ValueError(f"stage {st.name!r} returned unknown "
                                 f"mode {mode!r}")
            self._links.append({"stage": st.name, "block_out": block,
                                "mode": mode})
        self.out_block = block
        self.mode = mode
        self.terminal_tree = self._stages[-1].terminal
        for st in self._stages:
            route = st.resolve(routing.pipeline_tune_geom)
            if route is not None:
                obs.record_decision(
                    "pipeline_stage_route", route, pipeline=self.name,
                    stage=st.name, family=st.family)
        obs.record_decision(
            "pipeline_compile", self.name, block=self.block_len,
            out_block=self.out_block, mode=self.mode,
            stages=",".join(st.name for st in self._stages),
            routes=",".join(f"{st.name}={st.route}"
                            for st in self._stages
                            if st.route is not None))
        # every constant on the device now, never copied per block
        self.device = _platform.device()
        for st in self._stages:
            st.place(self.device)
        self._graphs: dict[tuple, _GraphStep] = {}
        self._eager: set = set()
        self._graph_lock = threading.Lock()
        # THE step: one instrumented call per block
        self._step = obs.instrumented_jit(
            self._fused, op="pipeline", route=self.name)
        # the honest-comparison twin: the SAME stage ops, one call per
        # stage per block — built lazily
        self._stage_jits = None
        with _live_lock:
            _LIVE.add(self)

    # -- state --------------------------------------------------------------

    def init_state(self, batch_shape: tuple = ()) -> tuple:
        """Zero-seeded carried state for a fresh stream (optionally
        batched: one independent stream per leading row), NumPy."""
        return tuple(st.init_state(tuple(batch_shape))
                     for st in self._stages)

    # -- the block step -----------------------------------------------------

    def _run_stages(self, x, states, where=None):
        new_states = []
        y = x
        for st, s in zip(self._stages, states):
            if where is not None:
                where["stage"] = st.name
            y, s2 = st.apply(y, s)
            new_states.append(s2)
        return y, tuple(new_states)

    def _fused(self, x, states):
        """The step of one block: a graph replay on the card (captured
        on the first block of each batch shape), the eager chain on the
        CPU."""
        if x.device.type != "cuda":
            self._eager.add(tuple(x.shape))
            return self._run_stages(x, states)
        key = tuple(x.shape)
        g = self._graphs.get(key)
        if g is None:
            with self._graph_lock:
                g = self._graphs.get(key)
                if g is None:
                    with obs.compile_timer(
                            "/veles/pipeline/graph_capture_duration"
                    ) as capture:
                        g = _GraphStep(self._run_stages, x, states,
                                       self.name)
                    obs.record_decision(
                        "pipeline_graph", "captured", pipeline=self.name,
                        shape=list(key),
                        seconds=round(capture.seconds, 6))
                    self._graphs[key] = g
        return g.run(x, states)

    def _device_state(self, state):
        return _tree_map(_platform.as_f32, state)

    def _run_fused(self, block, state):
        return self._step(_platform.as_f32(block),
                          self._device_state(state))

    def _run_unfused(self, block, state):
        """Per-stage dispatch of the SAME ops (the pre-fusion cost
        model): one eager call per stage per block."""
        if self._stage_jits is None:
            self._stage_jits = [
                obs.instrumented_jit(st.apply, op="pipeline_stage",
                                     route=f"{self.name}:{st.name}")
                for st in self._stages]
        y = _platform.as_f32(block)
        state = self._device_state(state)
        new_states = []
        for jfn, s in zip(self._stage_jits, state):
            y, s2 = jfn(y, s)
            new_states.append(s2)
        return y, tuple(new_states)

    def oracle_step(self, block, state):
        """One block through the stage-by-stage NumPy oracle twin — the
        degradation target (identical streaming semantics, exact state
        threading).  Returns NumPy."""
        y = np.asarray(_host(block), np.float64)
        state = _tree_map(_host, state)
        new_states = []
        for st, s in zip(self._stages, state):
            y, s2 = st.apply_na(y, s)
            new_states.append(s2)
        return _tree_map(_cast_out, y), tuple(new_states)

    def _oracle_fallback(self, block, state):
        """The oracle for a block and state that came from the host;
        None when either is already on the card (after the first block
        of a stream the carried state is), which retries and then
        re-raises."""
        if faults.on_card(block, *_tree_leaves(state, [])):
            return None
        return lambda: self.oracle_step(block, state)

    def process(self, block, state=None, fused: bool = True):
        """Feed one block (``[..., block_len]``); returns ``(out,
        state')``.  The fused path is ONE step (one graph replay on the
        card) under the pipeline class's circuit breaker at
        ``pipeline.dispatch``; a transient fault retries, then a host
        block degrades to the oracle twin and the stream continues with
        exact state.  ``fused=False`` dispatches stage by stage (the
        honest pre-fusion baseline) through the same fault policy."""
        if np.shape(block)[-1] != self.block_len:
            raise ValueError(
                f"block length {np.shape(block)[-1]} != compiled "
                f"{self.block_len}")
        if state is None:
            state = self.init_state(tuple(np.shape(block)[:-1]))
        with obs.span("pipeline.dispatch", pipeline=self.name,
                      fused=bool(fused)):
            return faults.breaker_guarded(
                PIPELINE_SITE, (self.name, self.block_len),
                (lambda: self._run_fused(block, state)) if fused
                else (lambda: self._run_unfused(block, state)),
                fallback=self._oracle_fallback(block, state),
                fallback_name="oracle", subsite=self.name)

    def serve_step(self, block, state, budget_s: float | None = None,
                   on_fault=None):
        """One (possibly row-batched) block for a serving layer: the
        same per-pipeline-class breaker and guarded dispatch as
        :meth:`process`, with a remaining deadline budget threaded in,
        returning ``(out, state', degraded)`` so a server can label
        oracle-served answers.  ``on_fault`` observes every retry and
        degrade (:func:`veles.simd_tpu_torch.runtime.faults.guarded`)."""
        box = {"deg": False}
        oracle = self._oracle_fallback(block, state)

        def fallback():
            box["deg"] = True
            return oracle()

        with obs.span("pipeline.dispatch", pipeline=self.name,
                      served=True):
            out, new_state = faults.breaker_guarded(
                PIPELINE_SITE, (self.name, self.block_len),
                lambda: self._run_fused(block, state),
                fallback=fallback if oracle is not None else None,
                fallback_name="oracle", subsite=self.name,
                budget_s=budget_s, on_fault=on_fault)
        return out, new_state, box["deg"]

    def captures(self, batch_shape) -> bool:
        """Would the fused step of a ``batch_shape`` block capture a
        CUDA graph first (on the card, no graph of that shape yet)?  A
        capture fails if another thread allocates or copies
        synchronously on the card meanwhile, so a serving layer keeps
        such a step exclusive of its other device work."""
        return (self.device.type == "cuda"
                and tuple(batch_shape) not in self._graphs)

    # -- serving-layer state marshalling ------------------------------------

    def check_state(self, state) -> None:
        """Validate a caller-supplied carried state against this
        pipeline's structure and per-stream leaf shapes; a malformed
        state (saved from a different pipeline or block size) raises
        ``ValueError``."""
        ref = self.init_state(())

        def walk(r, s, path):
            where = "/".join(path) or "state"
            if isinstance(r, tuple):
                if not isinstance(s, (tuple, list)) or len(s) != len(r):
                    raise ValueError(
                        f"pipeline {self.name!r} state at {where}: "
                        f"expected a {len(r)}-element tuple, got "
                        f"{type(s).__name__}")
                for i, (ri, si) in enumerate(zip(r, s)):
                    walk(ri, si, path + [str(i)])
                return
            try:
                shape = tuple(np.shape(s))
            except Exception:  # noqa: BLE001
                raise ValueError(
                    f"pipeline {self.name!r} state at {where}: not "
                    "an array") from None
            want = tuple(np.shape(r))
            if shape != want:
                raise ValueError(
                    f"pipeline {self.name!r} state at {where}: shape "
                    f"{shape} != expected {want} (state from another "
                    "pipeline or block size?)")

        walk(ref, state, [])

    def batch_states(self, row_states, rows: int) -> tuple:
        """Stack per-stream states into one ``rows``-row batched state
        (NumPy): ``row_states[i]`` is stream ``i``'s carried state or
        None (fresh stream); missing rows and pad rows stay
        zero-seeded."""
        base = self.init_state((int(rows),))

        def fill(base_node, idx, state_node):
            if isinstance(base_node, tuple):
                for b, s in zip(base_node, state_node):
                    fill(b, idx, s)
            else:
                base_node[idx] = _host(state_node)

        for i, rs in enumerate(row_states):
            if rs is not None:
                fill(base, i, rs)
        return base

    def state_rows(self, state, count: int) -> list:
        """Split a batched state back into ``count`` per-stream states
        (NumPy)."""
        state = _tree_map(_host, state)
        return [_tree_map(lambda a, i=i: a[i], state)
                for i in range(count)]

    def out_rows(self, out, count: int) -> list:
        """Split a batched step output into ``count`` per-stream
        outputs (NumPy arrays, or per-leaf for a terminal tuple
        stage)."""
        if self.terminal_tree:
            out = _tree_map(_host, out)
            return [_tree_map(lambda a, i=i: a[i], out)
                    for i in range(count)]
        out = _host(out)
        return [out[i] for i in range(count)]

    # -- whole-signal helpers ----------------------------------------------

    def _split(self, x):
        n = np.shape(x)[-1]
        if n % self.block_len != 0 or n == 0:
            raise ValueError(
                f"signal length {n} is not whole blocks of "
                f"{self.block_len}")
        return [x[..., i:i + self.block_len]
                for i in range(0, n, self.block_len)]

    def assemble(self, outs):
        """Per-block outputs -> the whole-stream NumPy array, per the
        chain mode: ``samples``/``frames`` concatenate (last / frames
        axis), ``rows`` stack a new block axis.  Terminal tuple stages
        (detect_peaks) assemble per leaf on a new block axis."""
        if self.terminal_tree:
            leaves = zip(*outs)
            return tuple(np.stack([_host(v) for v in leaf])
                         for leaf in leaves)
        outs = [_host(o) for o in outs]
        if self.mode == "samples":
            return np.concatenate(outs, axis=-1)
        if self.mode == "frames":
            return np.concatenate(outs, axis=-2)
        return np.stack(outs, axis=-2)

    def stream(self, x, state=None, fused: bool = True):
        """Block the whole signal, thread state through
        :meth:`process`, and :meth:`assemble` — the test/bench
        convenience.  Returns ``(assembled, final_state)``."""
        if state is None:
            state = self.init_state(tuple(np.shape(x)[:-1]))
        outs = []
        for block in self._split(x):
            out, state = self.process(block, state, fused=fused)
            outs.append(out)
        return self.assemble(outs), state

    def oracle(self, x):
        """ONE-SHOT whole-signal oracle of the streamed chain: each
        stage's closed-form streaming semantics evaluated over the full
        signal in NumPy float64 (no blocking, no state) — what any
        block decomposition of :meth:`stream` must reproduce."""
        y = np.asarray(_host(x), np.float64)
        block, mode = self.block_len, "samples"
        for st, link in zip(self._stages, self._links):
            y = st.oracle(y, block, mode)
            block, mode = link["block_out"], link["mode"]
        return y if self.terminal_tree else np.asarray(y)

    # -- introspection ------------------------------------------------------

    def describe(self) -> dict:
        """JSON-native chain summary (stages, routes, per-stage
        latencies, block geometry)."""
        return {"pipeline": self.name, "block_len": self.block_len,
                "out_block": self.out_block, "mode": self.mode,
                "stages": [dict(st.describe(), **{
                    k: v for k, v in link.items() if k != "stage"})
                    for st, link in zip(self._stages, self._links)]}

    def routes(self) -> dict:
        """Stage name -> resolved route (routed stages only)."""
        return {st.name: st.route for st in self._stages
                if st.route is not None}

    def compile_cache_size(self) -> int:
        """Prepared geometries behind the fused step: captured graphs
        on the card, eager plans (batch shapes seen) on the CPU."""
        return len(self._graphs) + len(self._eager)
