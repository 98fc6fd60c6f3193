"""``extend_mib_per_call``: the bytes that the DWT's boundary extension
writes on the device (``ops/wavelet._extend``, the program's
``wavelet_extend_bytes`` count, which a capture folds into the span
open around it) summed over the window's calls, over the calls, in MiB
(program counter, ``cellbench/progspans.py``)."""

from cellbench import progspans

NAME = "wavelet_extend_bytes"


def read(r):
    calls = progspans.calls(r)
    if not calls:
        return None
    counts = [s.attrs[NAME] for c in calls for s in [c.top, *c.spans]
              if NAME in s.attrs]
    if not counts:
        return None
    return sum(counts) / len(calls) / (1 << 20)
