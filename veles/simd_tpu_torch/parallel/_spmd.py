"""The shard runner: the port's counterpart of ``shard_map`` with the
``jax.lax`` collectives used inside it.

:func:`shard_map` splits each global operand by its partition spec
(:class:`P`; ``P()`` is replicated), runs the body once per shard of
the :class:`~veles.simd_tpu_torch.parallel.mesh.Mesh`, and assembles
the outputs by their specs into one global tensor on the mesh's first
device.

Each shard runs in its own thread (pooled: a call takes idle workers,
or starts new ones, and returns them), with its device current, and the
threads meet at every collective: the JAX bodies call collectives
partway through (a halo, then the local step; ``sharded_sosfilt``'s
local scan, an ``all_gather`` of the exit states, then the carry), so
a body cannot run to its end one shard at a time, and a body written
per shard keeps the JAX code's form line for line.  At a collective
every thread posts its value, the first shard computes every shard's
result (explicit copies between the shards' devices), and each thread
takes its own.  The rendezvous is one :class:`threading.Barrier`, which
a failing shard aborts so its siblings stop too.

Axes that span processes (``Mesh.dcn_axes``, from
:func:`~veles.simd_tpu_torch.parallel.distributed.hybrid_mesh`) go
through the ``torch.distributed`` process group: ``all_reduce`` for
``psum``/``pmin``/``pmax``, ``all_gather``, ``all_to_all_single``, and
``send``/``recv`` for ``ppermute``.  A collective over process-spanning
axes must name every one of them.  Outputs are gathered from every
process, so each process returns the whole global result.

The fp32 scopes of :mod:`~veles.simd_tpu_torch.runtime.precision` set
process-wide switches; the runner holds them for the whole run, so the
shards' own scopes (entered and left on their threads in any order)
restore the same values they found.
"""

from __future__ import annotations

import contextlib
import functools
import queue
import threading

import numpy as np
import torch
import torch.distributed as dist

from veles.simd_tpu_torch.runtime import precision as prx
from veles.simd_tpu_torch.utils.trace import traced

__all__ = ["P", "shard_map", "axis_index", "axis_size", "ppermute",
           "psum", "pmin", "pmax", "all_gather", "all_to_all"]


class P(tuple):
    """Partition spec: one mesh-axis name (or ``None``, replicated) per
    leading dimension; ``P()`` replicates the whole operand."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple(self)!r}"


_CTX = threading.local()


def _current():
    run = getattr(_CTX, "run", None)
    if run is None:
        raise RuntimeError("collectives and axis queries run only inside "
                           "a shard_map body")
    return run, _CTX.coord


def _axes(axis) -> tuple:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def _rank(mesh) -> int:
    return dist.get_rank() if mesh.dcn_axes else 0


class _Run:
    """One shard_map invocation: the mesh, this process's shards, and
    the rendezvous they share."""

    def __init__(self, mesh, rank, coords):
        self.mesh = mesh
        self.rank = rank
        self.coords = coords
        self.leader = coords[0]
        self.barrier = threading.Barrier(len(coords))
        self.slots = {}
        self.results = None
        self.names = mesh.axis_names

    def device(self, coord):
        return self.mesh.devices[coord]

    def dims(self, axes):
        dims = []
        for a in axes:
            if a not in self.names:
                raise ValueError(f"unknown mesh axis {a!r}; the mesh has "
                                 f"{self.names}")
            dims.append(self.names.index(a))
        return dims

    def group(self, coord, axes) -> list:
        """The shards that share ``coord`` outside ``axes``, ordered
        row-major over ``axes``."""
        dims = self.dims(axes)
        shape = self.mesh.devices.shape
        out = []
        for sub in np.ndindex(*[shape[d] for d in dims]):
            c = list(coord)
            for d, s in zip(dims, sub):
                c[d] = s
            out.append(tuple(c))
        return out

    def position(self, coord, axes) -> int:
        dims = self.dims(axes)
        shape = self.mesh.devices.shape
        return int(np.ravel_multi_index([coord[d] for d in dims],
                                        [shape[d] for d in dims]))

    def spans_processes(self, axes, mixed: bool = False) -> bool:
        """Does a collective over ``axes`` cross processes?  It must
        then name every process-spanning axis, and only the reductions
        (``mixed``) may name in-process axes beside them."""
        dcn = set(self.mesh.dcn_axes)
        hit = dcn & set(axes)
        if hit and (hit != dcn or (not mixed and len(hit) < len(axes))):
            raise NotImplementedError(
                f"a collective over {axes} must name every process-"
                f"spanning axis {self.mesh.dcn_axes}"
                + ("" if mixed else " and no other"))
        return bool(hit)

    def exchange(self, coord, value, compute):
        """Post ``value``; the leader computes every local shard's
        result from all posted values; return this shard's."""
        self.slots[coord] = value
        self.barrier.wait()
        if coord == self.leader:
            try:
                self.results = compute(dict(self.slots))
            except BaseException:
                self.barrier.abort()
                raise
        self.barrier.wait()
        return self.results[coord]


# ---------------------------------------------------------------------------
# axis queries and collectives (called inside a body)
# ---------------------------------------------------------------------------

def axis_index(axis) -> int:
    """This shard's coordinate along ``axis`` (a Python int)."""
    run, coord = _current()
    return run.position(coord, _axes(axis))


def axis_size(axis) -> int:
    """The size of mesh axis ``axis`` (a product for a tuple)."""
    run, _ = _current()
    return _axis_size_of(run.mesh, axis)


def _stacked(run, vals):
    """This process's values in shard order, stacked on the leader's
    device."""
    dev = run.device(run.leader)
    return torch.stack([vals[c].to(dev) for c in run.coords])


def _reduce(x, axis, how):
    run, coord = _current()
    axes = _axes(axis)
    fold = {"sum": lambda a, b: a + b, "min": torch.minimum,
            "max": torch.maximum}[how]

    def compute(vals):
        sums, out = {}, {}
        for c in vals:
            local = tuple(g for g in run.group(c, axes) if g in vals)
            if local not in sums:
                acc = vals[local[0]]
                for g in local[1:]:
                    acc = fold(acc, vals[g].to(acc.device))
                sums[local] = acc
            out[c] = sums[local].to(run.device(c))
        if run.spans_processes(axes, mixed=True):
            op = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
                  "max": dist.ReduceOp.MAX}[how]
            part = _stacked(run, out).contiguous()
            dist.all_reduce(part, op=op)
            out = {c: part[i].to(run.device(c))
                   for i, c in enumerate(run.coords)}
        return out

    return run.exchange(coord, torch.as_tensor(x), compute)


def psum(x, axis):
    """Sum of ``x`` over the shards along ``axis`` (a name or a tuple
    of names), in shard order."""
    return _reduce(x, axis, "sum")


def pmin(x, axis):
    return _reduce(x, axis, "min")


def pmax(x, axis):
    return _reduce(x, axis, "max")


def _dcn_gathered(run, vals):
    """Every process's values of this collective, ``[processes,
    local shards, ...]``, on the leader's device."""
    local = _stacked(run, vals).contiguous()
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, local)
    return parts


def ppermute(x, axis, perm):
    """``x`` from the shard that ``perm`` (``(source, destination)``
    pairs of positions along ``axis``) names as this shard's source;
    zeros where it names none."""
    run, coord = _current()
    axes = _axes(axis)
    perm = [(int(s), int(d)) for s, d in perm]

    def source(c):
        me = run.position(c, axes)
        src = [s for s, d in perm if d == me]
        return src[0] if src else None

    def compute(vals):
        if run.spans_processes(axes):
            return _dcn_ppermute(run, vals, perm, source)
        out = {}
        for c, v in vals.items():
            s = source(c)
            out[c] = (torch.zeros_like(v) if s is None
                      else vals[run.group(c, axes)[s]].to(run.device(c)))
        return out

    return run.exchange(coord, x, compute)


def _dcn_ppermute(run, vals, perm, source):
    """The process-spanning ppermute: the stacked local values go to
    the destination process, one send and one receive a pair."""
    local = _stacked(run, vals).contiguous()
    recv = torch.zeros_like(local)
    ops = [dist.P2POp(dist.isend, local, d)
           for s, d in perm if s == run.rank and d != run.rank]
    src = source(run.coords[0])
    if src is not None and src != run.rank:
        ops.append(dist.P2POp(dist.irecv, recv, src))
    elif src == run.rank:
        recv = local
    for req in (dist.batch_isend_irecv(ops) if ops else []):
        req.wait()
    return {c: recv[i].to(run.device(c)) for i, c in enumerate(run.coords)}


def all_gather(x, axis, tiled: bool = False):
    """Every shard's ``x`` along ``axis``, stacked on a new leading
    dimension in shard order (concatenated along dimension 0 when
    ``tiled``)."""
    run, coord = _current()
    axes = _axes(axis)

    def compute(vals):
        if run.spans_processes(axes):
            parts = _dcn_gathered(run, vals)
            rows = {c: [p[i] for p in parts]
                    for i, c in enumerate(run.coords)}
        else:
            rows = {c: [vals[g] for g in run.group(c, axes)]
                    for c in vals}
        join = torch.cat if tiled else torch.stack
        return {c: join([r.to(run.device(c)) for r in rows[c]])
                for c in vals}

    return run.exchange(coord, x, compute)


def all_to_all(x, axis, split_axis: int, concat_axis: int,
               tiled: bool = True):
    """The tiled all-to-all: shard ``j`` receives chunk ``j`` (of
    ``x`` split into ``axis_size`` chunks along ``split_axis``) from
    every shard, concatenated along ``concat_axis`` in shard order."""
    if not tiled:
        raise NotImplementedError("only the tiled all_to_all is ported")
    run, coord = _current()
    axes = _axes(axis)
    size = axis_size(axis)
    if x.shape[split_axis] % size:
        raise ValueError(f"all_to_all: dimension {split_axis} of "
                         f"{tuple(x.shape)} does not split {size} ways")

    def compute(vals):
        if run.spans_processes(axes):
            return _dcn_all_to_all(run, vals, size, split_axis,
                                   concat_axis)
        out = {}
        for c in vals:
            me = run.position(c, axes)
            chunks = [vals[g].chunk(size, dim=split_axis)[me]
                      .to(run.device(c)) for g in run.group(c, axes)]
            out[c] = torch.cat(chunks, dim=concat_axis)
        return out

    return run.exchange(coord, x, compute)


def _dcn_all_to_all(run, vals, size, split_axis, concat_axis):
    """The process-spanning all-to-all: chunk ``j`` of every local
    shard goes to process ``j`` in one ``all_to_all_single``."""
    dev = run.device(run.leader)
    send = torch.stack([
        torch.stack([vals[c].to(dev).chunk(size, dim=split_axis)[j]
                     for c in run.coords])
        for j in range(size)]).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send)
    return {c: torch.cat([recv[p, i] for p in range(size)],
                         dim=concat_axis).to(run.device(c))
            for i, c in enumerate(run.coords)}


# ---------------------------------------------------------------------------
# split, run, assemble
# ---------------------------------------------------------------------------

def _spec_list(specs, n):
    if isinstance(specs, P):
        return [specs] * n
    specs = list(specs)
    if len(specs) != n:
        raise ValueError(f"{len(specs)} specs for {n} values")
    return specs


def _block_slices(run, spec, coord, shape):
    """The slice of a global array of ``shape`` that ``coord`` holds."""
    index = []
    for d, names in enumerate(spec):
        if names is None:
            index.append(slice(None))
            continue
        axes = _axes(names)
        n = _axis_size_of(run.mesh, axes)
        if shape[d] % n:
            raise ValueError(
                f"dimension {d} of {tuple(shape)} is not divisible by "
                f"{'x'.join(axes)}={n}")
        blk = shape[d] // n
        i = run.position(coord, axes)
        index.append(slice(i * blk, (i + 1) * blk))
    return tuple(index)


def _axis_size_of(mesh, axes) -> int:
    return int(np.prod([mesh.shape[a] for a in _axes(axes)]))


def _split(run, value, spec, coord):
    if not isinstance(value, torch.Tensor):
        return value
    dev = run.device(coord)
    if not spec:
        return value.to(dev)
    return value[_block_slices(run, spec, coord, value.shape)].to(dev)


def _assemble(run, blocks, spec, dev):
    """One output: the global tensor on ``dev`` from every shard's
    block (the shards at coordinate 0 of each axis ``spec`` leaves
    out stand for their replicas)."""
    named = {a for names in spec if names is not None
             for a in _axes(names)}
    first = next(iter(blocks.values()))
    shape = list(first.shape)
    for d, names in enumerate(spec):
        if names is not None:
            shape[d] *= _axis_size_of(run.mesh, names)
    out = torch.empty(shape, dtype=first.dtype, device=dev)
    dims = [run.names.index(a) for a in run.names if a not in named]
    for c, blk in blocks.items():
        if any(c[d] for d in dims):
            continue
        out[_block_slices(run, spec, c, shape)] = blk
    return out


def _all_blocks(run, blocks):
    """Every shard's block of one output, gathered from every process
    when the mesh spans processes."""
    if not run.mesh.dcn_axes:
        return blocks
    parts = _dcn_gathered(run, blocks)
    return {c: parts[int(run.mesh.processes[c])][
                run.mesh.local_coords(int(run.mesh.processes[c])).index(c)]
            for c in np.ndindex(run.mesh.devices.shape)}


def _body(run, fn, coord, args, results, errors):
    prev = (getattr(_CTX, "run", None), getattr(_CTX, "coord", None))
    _CTX.run, _CTX.coord = run, coord
    dev = run.device(coord)
    try:
        # a shard body runs as a traced JAX body does: no instrumented
        # call in it records resources
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()), traced():
            results[coord] = fn(*args)
    except threading.BrokenBarrierError:
        pass    # a sibling failed; its error is the one reported
    except BaseException as e:  # noqa: BLE001 — re-raised by the caller
        errors.append(e)
        run.barrier.abort()
    finally:
        _CTX.run, _CTX.coord = prev


class _Worker:
    """A pooled shard thread: it runs one shard's body a task, then
    returns itself to the idle pool, so a sharded call reuses threads
    and starts none of its own."""

    def __init__(self):
        self.tasks = queue.SimpleQueue()
        threading.Thread(target=self._loop, name="shard-worker",
                         daemon=True).start()

    def _loop(self):
        while True:
            self.tasks.get()()
            with _IDLE_LOCK:
                _IDLE.append(self)


_IDLE: list = []
_IDLE_LOCK = threading.Lock()


def _acquire(n: int) -> list:
    """``n`` idle workers, new ones where the pool has too few: every
    shard of a call must run at once (they meet at barriers), so a call
    never waits for a worker another call holds."""
    with _IDLE_LOCK:
        got = [_IDLE.pop() for _ in range(min(n, len(_IDLE)))]
    return got + [_Worker() for _ in range(n - len(got))]


def _task(done, *body_args):
    try:
        _body(*body_args)
    finally:
        done.set()


def _execute(fn, mesh, args, in_specs):
    rank = _rank(mesh)
    coords = mesh.local_coords(rank)
    run = _Run(mesh, rank, coords)
    specs = _spec_list(in_specs, len(args))
    shard_args = {c: [_split(run, a, s, c) for a, s in zip(args, specs)]
                  for c in coords}
    results, errors = {}, []
    with contextlib.ExitStack() as scopes:
        scopes.enter_context(prx.fp32_matmul())
        cards = [d for d in mesh.devices.flat if d.type == "cuda"]
        if cards:
            scopes.enter_context(prx.fp32_conv(cards[0]))
        if len(coords) == 1:
            _body(run, fn, coords[0], shard_args[coords[0]], results,
                  errors)
        else:
            done = [threading.Event() for _ in coords]
            for w, c, ev in zip(_acquire(len(coords)), coords, done):
                w.tasks.put(functools.partial(
                    _task, ev, run, fn, c, shard_args[c], results, errors))
            for ev in done:
                ev.wait()
    if errors:
        raise errors[0]
    if len(results) != len(coords):
        raise RuntimeError("a shard stopped without an error")
    return run, results


def shard_map(fn, mesh, in_specs, out_specs):
    """``fn`` run once per shard of ``mesh``: operands split by
    ``in_specs`` (one :class:`P` for every operand, or a tuple of one
    an operand),
    outputs assembled by ``out_specs`` (one :class:`P` for a single
    output or for each of a tuple's, or a tuple of them) into global
    tensors on the mesh's first device."""

    def run_all(*args):
        run, results = _execute(fn, mesh, args, in_specs)
        dev = mesh.first_device(run.rank)
        first = results[run.leader]
        multi = isinstance(first, (tuple, list))
        count = len(first) if multi else 1
        specs = _spec_list(out_specs, count)
        outs = []
        for k, spec in enumerate(specs):
            blocks = {c: (r[k] if multi else r) for c, r in results.items()}
            outs.append(_assemble(run, _all_blocks(run, blocks), spec,
                                  dev))
        return tuple(outs) if multi else outs[0]

    return run_all
