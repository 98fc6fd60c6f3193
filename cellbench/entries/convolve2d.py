"""The 2D filter of the port, as a batch user calls it.

``ops.convolve2d.cross_correlate2d(x, w, mode=...)`` or
``ops.convolve2d.convolve2d(x, w, mode=..., boundary=...)`` on an
``x`` of ``[images, n0, n1]`` with one normalised ``k x k`` Gaussian
window ``w`` (MATLAB's ``fspecial('gaussian', k, sigma)``), through the
entry, the boundary extension, the ``runtime/faults`` guard, the
``convolve2d`` routing table and the route it picks.  The window is
built once, outside the timed path, on the program's device.  A call
returns the output as the API returns it: the mode's slice, which may
be a view of a larger result.
"""

import torch

from cellbench import work2d

OPERANDS = {"x": {"shape": ["images", "n0", "n1"], "pool": True}}


def gaussian(k: int, sigma: float) -> torch.Tensor:
    """``fspecial('gaussian', k, sigma)``: float64 ``exp(-(p^2 + q^2) /
    (2 sigma^2))`` over ``p, q`` in ``-(k-1)/2 .. (k-1)/2``, divided by
    its sum, then rounded to float32."""
    r = torch.arange(k, dtype=torch.float64) - (k - 1) / 2
    g = torch.exp(-(r[:, None] ** 2 + r[None, :] ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).to(torch.float32)


class Entry:
    """One call of the timed path: ``entry(x)`` returns the program's
    filtered images and does not wait for the card."""

    def __init__(self, params, fixed):
        from veles.simd_tpu_torch.ops import convolve2d
        from veles.simd_tpu_torch.utils.platform import device

        self._op = getattr(convolve2d, params["op"])
        self._w = gaussian(int(params["k"]), float(params["sigma"])).to(
            device())
        self._mode = params["mode"]
        self._boundary = params["boundary"]

    def __call__(self, x):
        return self._op(x, self._w, mode=self._mode,
                        boundary=self._boundary)

    def close(self):
        self._op = self._w = None


def samples(params) -> int:
    """Input samples of one call."""
    return int(params["images"]) * int(params["n0"]) * int(params["n1"])


def least_work(params) -> tuple[float, float]:
    """``(flops, bytes)`` of one call's least work."""
    k = int(params["k"])
    return work2d.filter2d_work(params["images"], params["n0"],
                                params["n1"], k, k, params["mode"])
