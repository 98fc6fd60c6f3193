"""The convolve handle API of the port, as a batch user calls it.

``ops.convolve.convolve_initialize(n, taps)`` once, then
``ops.convolve.convolve(handle, x, h)`` on an ``x`` of ``[rows, n]``: the
full ``n + taps - 1`` convolution of every row with one filter, through
the entry, the ``runtime/faults`` guard, the ``convolve.os`` routing
table and the route it picks.
"""

from cellbench import work

# operand name -> its shape (keys of the cell's parameters) and whether
# the pool holds distinct batches of it or one copy serves every call
OPERANDS = {"x": {"shape": ["rows", "n"], "pool": True},
            "h": {"shape": ["taps"], "pool": False}}


class Entry:
    """One call of the timed path: ``entry(x)`` returns the program's
    output and does not wait for the card."""

    def __init__(self, params, fixed):
        from veles.simd_tpu_torch.ops import convolve

        self._convolve = convolve
        self._handle = convolve.convolve_initialize(int(params["n"]),
                                                    int(params["taps"]))
        self._h = fixed["h"]
        self._mode = params["mode"]

    def __call__(self, x):
        return self._convolve.convolve(self._handle, x, self._h,
                                       mode=self._mode)

    def close(self):
        self._convolve.convolve_finalize(self._handle)
        self._handle = self._h = None


def samples(params) -> int:
    """Input samples of one call."""
    return int(params["rows"]) * int(params["n"])


def least_work(params) -> tuple[float, float]:
    """``(flops, bytes)`` of one call's least work."""
    return work.conv_work(params["rows"], params["n"], params["taps"])
