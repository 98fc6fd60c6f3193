"""Multi-process semantics of the port with real processes (localhost,
``gloo``), and its in-process ``hybrid_mesh`` cases.

The twin of ``tests/test_distributed.py``: two
``torch_distributed_worker.py`` processes join one ``torch.distributed``
group and run ``tests/distributed_worker.py``'s checks against
``veles.simd_tpu_torch.parallel`` (a ``psum`` across both axes,
``sharded_convolve_batch`` with dp over processes, the SWT round trip,
the all-to-all 2D wavelet over dp); the in-process cases hold
``hybrid_mesh`` to the JAX package's on one process.  The
two-process run takes a few seconds on the CPU.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import pytest

from veles.simd_tpu.parallel import distributed as jdist
from veles.simd_tpu_torch.parallel import distributed as tdist
from veles.simd_tpu_torch.utils import config as tconfig

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_distributed_worker.py")


@pytest.fixture(autouse=True)
def _cpu_device():
    prev = tconfig.get_config()
    tconfig.set_config(device="cpu")
    yield
    tconfig.set_config(**dataclasses.asdict(prev))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("nproc", [2])
def test_multiprocess_collectives(nproc):
    port = _free_port()
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), str(nproc), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True)
        for pid in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (
            f"worker {pid} rc={p.returncode}\n{out[-3000:]}")
        assert f"worker {pid}/{nproc} ok" in out


# ---- in-process hybrid_mesh cases (one process: process_count=1, the
# port's 8 default shards beside the conftest's 8 virtual devices) -----

def test_hybrid_mesh_single_process():
    mesh = tdist.hybrid_mesh(dcn={"dp": 1}, ici={"sp": 2, "tp": 4})
    jmesh = jdist.hybrid_mesh(dcn={"dp": 1}, ici={"sp": 2, "tp": 4})
    assert mesh.axis_names == jmesh.axis_names == ("dp", "sp", "tp")
    assert mesh.shape == jmesh.shape == {"dp": 1, "sp": 2, "tp": 4}
    assert mesh.devices.size == jmesh.devices.size == 8
    assert tdist.process_count() == 1 and tdist.process_index() == 0


def test_hybrid_mesh_ici_only():
    assert tdist.hybrid_mesh(ici={"tp": 8}).shape == \
        jdist.hybrid_mesh(ici={"tp": 8}).shape == {"tp": 8}


def test_hybrid_mesh_validates_sizes():
    for dist in (tdist, jdist):
        with pytest.raises(ValueError, match="dcn"):
            dist.hybrid_mesh(dcn={"dp": 3}, ici={"sp": 8})
        with pytest.raises(ValueError, match="ici"):
            dist.hybrid_mesh(dcn={"dp": 1}, ici={"sp": 3})
        with pytest.raises(ValueError, match="at least one"):
            dist.hybrid_mesh()


def test_initialize_needs_every_address_part():
    with pytest.raises(ValueError, match="coordinator_address"):
        tdist.initialize()
    tdist.shutdown()    # idempotent outside a process group
