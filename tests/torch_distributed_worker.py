"""Worker for tests/test_torch_distributed.py — one simulated host of
the port.

Run as ``python torch_distributed_worker.py <pid> <nproc> <port>``.
Holds 4 shards on the CPU (``VELES_SIMD_MESH_SHARDS=4``), joins a
``gloo`` process group, builds a hybrid dp(processes)×sp(shards) mesh,
and checks ``tests/distributed_worker.py``'s cross-process semantics on
``veles.simd_tpu_torch.parallel``:

* a ``psum`` spanning both axes (the all-reduce crossing processes),
  and a periodic ``ppermute`` over the process axis,
* ``sharded_convolve_batch`` with the batch over processes and each
  signal's length over the process's shards,
* the sharded SWT round trip over the in-process axis,
* the all-to-all 2D wavelet with its transform axis over processes.

Every sharded result is the whole global tensor in each process.
Exits nonzero on any mismatch; the parent test asserts both workers
pass.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
os.environ["VELES_SIMD_MESH_SHARDS"] = "4"

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main(pid: int, nproc: int, port: str) -> None:
    from veles.simd_tpu_torch.ops import wavelet as wv
    from veles.simd_tpu_torch.parallel import (
        distributed, halo_exchange_left, sharded_convolve_batch,
        sharded_swt,
        sharded_swt_reconstruct, sharded_wavelet_apply2d)
    from veles.simd_tpu_torch.parallel import _spmd
    from veles.simd_tpu_torch.utils.config import set_config

    torch.set_num_threads(1)
    set_config(device="cpu")
    distributed.initialize(f"127.0.0.1:{port}", num_processes=nproc,
                           process_id=pid)
    assert distributed.process_count() == nproc
    assert distributed.process_index() == pid

    mesh = distributed.hybrid_mesh(dcn={"dp": nproc}, ici={"sp": 4})
    assert mesh.axis_names == ("dp", "sp")
    assert dict(mesh.shape) == {"dp": nproc, "sp": 4}
    # DCN axis outermost: each mesh row must be one process's shards
    for row in mesh.processes:
        assert len(set(row.tolist())) == 1, row

    # all-reduce across both axes (crosses the process boundary)
    def total(x):
        return _spmd.psum(torch.sum(x), ("dp", "sp"))

    x = torch.arange(nproc * 32, dtype=torch.float32).reshape(nproc, 32)
    got = float(_spmd.shard_map(total, mesh, in_specs=_spmd.P("dp", "sp"),
                                out_specs=_spmd.P())(x))
    want = float(np.arange(nproc * 32).sum())
    assert got == want, (got, want)

    # a periodic ppermute over the process axis (send/recv)
    def ring(v):
        return halo_exchange_left(v, 2, "dp", periodic=True)

    y = torch.arange(nproc * 8, dtype=torch.float32).reshape(nproc, 8)
    got = _spmd.shard_map(ring, mesh, in_specs=_spmd.P("dp", "sp"),
                          out_specs=_spmd.P("dp", "sp"))(y)
    np.testing.assert_array_equal(got.numpy(),
                                  np.roll(y.numpy(), 1, axis=0))

    # batch over processes, sequence over a process's shards
    rng = np.random.RandomState(0)
    xb = rng.randn(2 * nproc, 256).astype(np.float32)
    ker = rng.randn(9).astype(np.float32)
    out = sharded_convolve_batch(xb, ker, mesh, batch_axis="dp",
                                 seq_axis="sp").numpy()
    for i in range(len(xb)):
        np.testing.assert_allclose(out[i], np.convolve(xb[i], ker),
                                   atol=1e-3)

    # sharded wavelet round trip over the in-process axis
    xs = rng.randn(2 * nproc, 256).astype(np.float32)
    bands = sharded_swt("daub", 8, 2, xs, mesh, axis="sp")
    rec = sharded_swt_reconstruct("daub", 8, 2, bands, mesh, axis="sp")
    np.testing.assert_allclose(rec.numpy(), xs, atol=1e-3)

    # all-to-all 2D wavelet with the transform axis over processes —
    # the all_to_all crossing the process boundary
    img = rng.randn(8 * nproc, 32).astype(np.float32)
    got = sharded_wavelet_apply2d("daub", 4, wv.ExtensionType.MIRROR, img,
                                  mesh, axis="dp")
    want = wv.wavelet_apply2d("daub", 4, wv.ExtensionType.MIRROR, img,
                              simd=False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3)

    distributed.shutdown()
    print(f"worker {pid}/{nproc} ok", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
