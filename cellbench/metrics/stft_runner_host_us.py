"""``stft_runner_host_us``: the median over the window's calls of the
host time of the STFT's route runner: the program's ``stft.route``
spans of a call, summed.  The span covers the fused kernel's wrapper
(checks, allocation, C launch), or the basis lookup, framing and
matmul launches of the library routes (program spans,
``cellbench/progspans.py``)."""

from cellbench import progspans

NAMES = ("stft.route",)


def read(r):
    calls = progspans.calls(r)
    if not calls or not any(s.name in NAMES for c in calls
                            for s in c.spans):
        return None
    return progspans.median_us(c.summed(NAMES) for c in calls)
