"""``stft_scratch_mib_per_call``: the bytes of the device intermediates
that the STFT's route writes besides its output (the ``scratch_bytes``
attribute of the program's ``stft.route`` span: the contiguous frames
and the basis product of the basis matmul, the windowed frames of the
FFT route, none for the fused kernel) summed over the window's calls,
over the calls, in MiB (program counter, ``cellbench/progspans.py``)."""

from cellbench import progspans

NAME = "scratch_bytes"


def read(r):
    calls = progspans.calls(r)
    if not calls:
        return None
    counts = [s.attrs[NAME] for c in calls for s in c.spans
              if s.name == "stft.route" and s.attrs.get(NAME) is not None]
    if not counts:
        return None
    return sum(counts) / len(calls) / (1 << 20)
