"""Multi-process bootstrap: the distributed communication backend (the
port's ``veles.simd_tpu.parallel.distributed``), on
``torch.distributed``.

Usage on N processes (same program in each; one card a process on
CUDA):

    from veles.simd_tpu_torch.parallel import distributed
    distributed.initialize("127.0.0.1:29500", num_processes=N,
                           process_id=rank)
    mesh = distributed.hybrid_mesh(dcn={"dp": distributed.process_count()},
                                   ici={"sp": 4})
    # sharded ops over `mesh`: "dp" collectives ride the process
    # group, "sp" collectives stay between one process's shards

The backend is explicit: ``gloo`` when ``Config.device`` is ``cpu``,
``nccl`` when it is ``cuda`` (one card a process, ``cuda:<local
rank>``); nothing is swapped in when one fails.  A process's shards
(the ``ici`` axes) live in it as a mesh of local devices
(:func:`veles.simd_tpu_torch.parallel.mesh.local_devices`); the
``dcn`` axes are outermost, so each row of the mesh is one process's
shards.  ``tests/test_torch_distributed.py`` runs two ``gloo``
processes on one host.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from veles.simd_tpu_torch.parallel.mesh import Mesh, local_devices
from veles.simd_tpu_torch.utils.config import get_config

__all__ = ["initialize", "shutdown", "process_count", "process_index",
           "hybrid_mesh"]


def _live() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join (or create) the process group.

    ``coordinator_address`` (``host:port``, reachable from every
    process; process 0 listens there), ``num_processes`` and
    ``process_id`` are required: nothing here detects a cluster.  The
    backend follows ``Config.device``: ``gloo`` for ``cpu``, ``nccl``
    for ``cuda`` with ``cuda:<process_id % device_count()>`` made
    current.
    """
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("initialize needs coordinator_address, "
                         "num_processes and process_id")
    device = get_config().device
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("Config.device is 'cuda' but no card is "
                               "present; set_config(device='cpu') runs "
                               "the gloo backend")
        torch.cuda.set_device(int(process_id) % torch.cuda.device_count())
    backend = "nccl" if device == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id))


def shutdown() -> None:
    """Leave the process group (idempotent)."""
    if _live():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if _live() else 1


def process_index() -> int:
    return dist.get_rank() if _live() else 0


def hybrid_mesh(dcn: dict[str, int] | None = None,
                ici: dict[str, int] | None = None) -> Mesh:
    """Mesh whose ``dcn`` axes span processes and ``ici`` axes stay in
    one process.

    Axis order puts the DCN axes outermost — collectives over an inner
    (ICI) axis then touch only one process's shards, and only the outer
    axes pay the process group's latency.  DCN sizes must multiply to
    :func:`process_count` and ICI sizes to the process's shard count
    (:func:`~veles.simd_tpu_torch.parallel.mesh.local_devices`).
    Processes are laid out process-major: process ``r`` owns the mesh
    row at DCN coordinate ``r``.
    """
    dcn = dict(dcn or {})
    ici = dict(ici or {})
    if not dcn and not ici:
        raise ValueError("at least one dcn or ici axis is required")
    n_proc = process_count()
    devices = local_devices()
    n_local = len(devices)
    dcn_sizes = [int(s) for s in dcn.values()]
    ici_sizes = [int(s) for s in ici.values()]
    if int(np.prod(dcn_sizes or [1])) != n_proc:
        raise ValueError(f"dcn axes {dcn} must multiply to "
                         f"process_count()={n_proc}")
    if int(np.prod(ici_sizes or [1])) != n_local:
        raise ValueError(f"ici axes {ici} must multiply to "
                         f"local_device_count()={n_local}")
    names = tuple(dcn) + tuple(ici)
    shape = dcn_sizes + ici_sizes
    if n_proc > 1 and devices[0].type == "cuda":
        # one card a process: process p's shards on the card
        # initialize() made current there
        cards = torch.cuda.device_count()
        devices = [d for p in range(n_proc)
                   for d in [torch.device("cuda", p % cards)] * n_local]
    else:
        devices = devices * n_proc
    flat = np.empty(n_proc * n_local, dtype=object)
    flat[:] = devices
    procs = np.repeat(np.arange(n_proc), n_local)
    return Mesh(flat.reshape(shape), names,
                processes=procs.reshape(shape),
                dcn_axes=tuple(dcn) if n_proc > 1 else ())
