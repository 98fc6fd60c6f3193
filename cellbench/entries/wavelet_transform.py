"""The multi-level DWT of the port, as a batch user calls it.

``ops.wavelet.wavelet_transform(family, order, ext, x, levels)`` on an
``x`` of ``[rows, n]``: every level's highpass band and the last
lowpass band, through the entry, the ``wavelet`` routing table and the
route it picks at each level.
"""

from cellbench import work

OPERANDS = {"x": {"shape": ["rows", "n"], "pool": True}}


class Entry:
    """One call of the timed path: ``entry(x)`` returns the program's
    bands and does not wait for the card."""

    def __init__(self, params, fixed):
        from veles.simd_tpu_torch.ops import wavelet

        self._transform = wavelet.wavelet_transform
        self._args = (params["family"], int(params["order"]),
                      params["ext"])
        self._levels = int(params["levels"])

    def __call__(self, x):
        return self._transform(*self._args, x, self._levels)

    def close(self):
        self._transform = None


def samples(params) -> int:
    """Input samples of one call."""
    return int(params["rows"]) * int(params["n"])


def least_work(params) -> tuple[float, float]:
    """``(flops, bytes)`` of one call's least work."""
    return work.dwt_work(params["rows"], params["n"], params["order"],
                         params["levels"])
