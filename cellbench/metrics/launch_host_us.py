"""``launch_host_us``: the median over the window's calls of the host
time of the routes' runners: the program's ``convolve.os_route`` and
``wavelet_apply.dispatch`` spans of a call, summed.  A runner covers a
kernel wrapper's allocations, table lookups and C launch, or a library
route's torch ops with the DWT's boundary extension (program spans,
``cellbench/progspans.py``)."""

from cellbench import progspans


def read(r):
    calls = progspans.calls(r)
    if not calls or not any(s.name in progspans.RUNNERS for c in calls
                            for s in c.spans):
        return None
    return progspans.median_us(c.summed(progspans.RUNNERS) for c in calls)
