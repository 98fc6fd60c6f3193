"""``route_host_us``: the median over the window's calls of the host
time spent choosing routes: the program's ``routing.select`` spans of a
call, summed (the ``convolve.os`` and ``wavelet`` tables, the
``wavelet.cascade`` gate; program spans, ``cellbench/progspans.py``)."""

from cellbench import progspans

NAMES = ("routing.select",)


def read(r):
    calls = progspans.calls(r)
    if not calls or not any(s.name in NAMES for c in calls
                            for s in c.spans):
        return None
    return progspans.median_us(c.summed(NAMES) for c in calls)
