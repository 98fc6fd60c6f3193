"""The STFT of the port, as a batch user calls it.

``ops.spectral.stft(x, frame_length, hop)`` on an ``x`` of ``[rows,
n]`` with the default periodic Hann window: the one-sided complex64
spectrum ``[rows, frames, frame_length // 2 + 1]`` through the entry,
the ``runtime/faults`` guard, the ``stft`` routing table and the route
it picks.  The entry returns ``torch.view_as_real`` of the spectrum, a
view and no copy, because the output check casts each output to
float64, which would drop a complex tensor's imaginary part.
"""

import torch

from cellbench import work

OPERANDS = {"x": {"shape": ["rows", "n"], "pool": True}}


class Entry:
    """One call of the timed path: ``entry(x)`` returns the program's
    spectrum as a real view and does not wait for the card."""

    def __init__(self, params, fixed):
        from veles.simd_tpu_torch.ops import spectral

        self._stft = spectral.stft
        self._frame = int(params["frame_length"])
        self._hop = int(params["hop"])

    def __call__(self, x):
        return torch.view_as_real(self._stft(x, self._frame, self._hop))

    def close(self):
        self._stft = None


def samples(params) -> int:
    """Input samples of one call."""
    return int(params["rows"]) * int(params["n"])


def least_work(params) -> tuple[float, float]:
    """``(flops, bytes)`` of one call's least work."""
    return work.stft_work(params["rows"], params["n"],
                          params["frame_length"], params["hop"])
