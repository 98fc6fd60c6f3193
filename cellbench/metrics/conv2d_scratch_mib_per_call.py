"""``conv2d_scratch_mib_per_call``: the bytes of the device
intermediates that a 2D filter call writes besides the outputs it
returns (the ``scratch_bytes`` attributes of the program's
``convolve2d.extend`` span, the boundary extension's copies, and of
its ``convolve2d.route`` span: the part of the 2D kernel's output that
the mode slices away, or the FFT route's padded operands, spectra,
product and inverse) summed over the window's calls, over the calls,
in MiB (program counter, ``cellbench/progspans.py``).  None where the
program records no counted ``convolve2d.route`` span."""

from cellbench import progspans

NAME = "scratch_bytes"
SPANS = ("convolve2d.route", "convolve2d.extend")


def read(r):
    calls = progspans.calls(r)
    if not calls:
        return None
    spans = [s for c in calls for s in c.spans
             if s.name in SPANS and s.attrs.get(NAME) is not None]
    if not any(s.name == SPANS[0] for s in spans):
        return None
    return sum(s.attrs[NAME] for s in spans) / len(calls) / (1 << 20)
