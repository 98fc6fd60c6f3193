"""``csrc_launches_per_call``: the change over the window of the
program's launch counter of its own CUDA kernels
(``veles.simd_tpu_torch.ops.cuda_kernels.LAUNCHES``), over the calls.
It says which route ran: 0 for a library route."""


def read(r):
    return r.launches / r.calls
