"""``conv2d_runner_host_us``: the median over the window's calls of the
host time of the 2D filter's route runner: the program's
``convolve2d.route`` spans of a call, summed.  The span covers the 2D
kernel's wrapper (checks, allocation, C launch), or the library
route's torch ops (the FFT product's transforms, or cuDNN's
``conv2d``) (program spans, ``cellbench/progspans.py``)."""

from cellbench import progspans

NAMES = ("convolve2d.route",)


def read(r):
    calls = progspans.calls(r)
    if not calls or not any(s.name in NAMES for c in calls
                            for s in c.spans):
        return None
    return progspans.median_us(c.summed(NAMES) for c in calls)
