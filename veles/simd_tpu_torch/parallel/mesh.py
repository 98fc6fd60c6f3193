"""Mesh construction helpers (the port's
``veles.simd_tpu.parallel.mesh``).

A :class:`Mesh` is an array of ``torch.device`` shards with named axes,
held in one process: a device may repeat, so eight shards may share one
card (or the CPU), as the JAX tests' eight virtual CPU devices share
one host.  The axis-name conventions are the JAX package's:

* ``"dp"`` — data parallel (batch of independent signals/planes),
* ``"sp"`` — sequence parallel (a single long signal sharded along its
  length, the distributed overlap-save axis),
* ``"tp"`` — tensor parallel (GEMM contracting dimension).

The default shard list comes from ``Config.device``: ``$VELES_SIMD_
MESH_SHARDS`` shards (8 unless set), on ``cpu``, or on the visible
cards in turn (``cuda:i % device_count()``).  Axes that span processes
(:func:`veles.simd_tpu_torch.parallel.distributed.hybrid_mesh`) carry
the owning process of each shard in :attr:`Mesh.processes`.
"""

from __future__ import annotations

import collections
import os

import numpy as np
import torch

from veles.simd_tpu_torch.utils.platform import device as _config_device

__all__ = ["make_mesh", "default_mesh"]

MESH_SHARDS_ENV = "VELES_SIMD_MESH_SHARDS"
DEFAULT_MESH_SHARDS = 8


class Mesh:
    """Named axes over an object array of ``torch.device`` shards.

    ``shape`` maps each axis name to its size, in axis order (what
    ``runtime.routing.mesh_class`` and the tune cache's mesh stamp
    read); ``processes`` holds each shard's process index (all 0 for a
    mesh of one process) and ``dcn_axes`` the axes that span
    processes."""

    def __init__(self, devices, axis_names, processes=None,
                 dcn_axes=()):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"{self.devices.ndim}-D device array for axes "
                f"{self.axis_names}")
        self.processes = (np.zeros(self.devices.shape, np.int64)
                          if processes is None
                          else np.asarray(processes, np.int64))
        self.dcn_axes = tuple(dcn_axes)

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        return collections.OrderedDict(
            zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def local_coords(self, process_index: int = 0) -> list:
        """The mesh coordinates of ``process_index``'s shards, in
        row-major order."""
        return [c for c in np.ndindex(self.devices.shape)
                if int(self.processes[c]) == process_index]

    def first_device(self, process_index: int = 0) -> torch.device:
        """Where results land: the first shard ``process_index`` owns."""
        return self.devices[self.local_coords(process_index)[0]]

    def _key(self):
        return (self.axis_names, tuple(self.devices.shape),
                tuple(str(d) for d in self.devices.flat),
                tuple(int(p) for p in self.processes.flat),
                self.dcn_axes)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        devs = sorted({str(d) for d in self.devices.flat})
        return (f"Mesh({dict(self.shape)}, devices={devs}"
                + (f", dcn={self.dcn_axes}" if self.dcn_axes else "")
                + ")")


def mesh_shards() -> int:
    """Shards of a default mesh: ``$VELES_SIMD_MESH_SHARDS`` (8)."""
    n = int(os.environ.get(MESH_SHARDS_ENV, DEFAULT_MESH_SHARDS))
    if n < 1:
        raise ValueError(f"{MESH_SHARDS_ENV} must be >= 1, got {n}")
    return n


def local_devices(n: int | None = None) -> list:
    """``n`` shard devices (default :func:`mesh_shards`) on
    ``Config.device``: the CPU, or the visible cards in turn.  Raises
    as every entry point does when the device is ``cuda`` and no card
    is present."""
    n = mesh_shards() if n is None else int(n)
    dev = _config_device()
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        return [torch.device("cuda", i % cards) for i in range(n)]
    return [dev] * n


def make_mesh(axis_sizes: dict[str, int] | None = None,
              devices=None) -> Mesh:
    """Build a mesh from ``{axis_name: size}`` (sizes must multiply to the
    device count; a single ``-1`` size is inferred)."""
    devices = (local_devices() if devices is None
               else [torch.device(d) for d in devices])
    n = len(devices)
    if not axis_sizes:
        axis_sizes = {"dp": n}
    names = list(axis_sizes)
    sizes = [int(s) for s in axis_sizes.values()]
    if sizes.count(-1) == 1:
        known = int(np.prod([s for s in sizes if s != -1]))
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(
            f"axis sizes {dict(zip(names, sizes))} != {n} devices")
    dev_array = np.empty(n, dtype=object)
    dev_array[:] = devices
    return Mesh(dev_array.reshape(sizes), names)


def default_mesh(axis: str = "dp") -> Mesh:
    """All devices on a single named axis."""
    return make_mesh({axis: len(local_devices())})
