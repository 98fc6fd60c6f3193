"""``guard_host_us``: the median over the window's calls of the host
time of the ``runtime/faults`` guard, its breaker and the dispatch
around them: the program's ``convolve.dispatch`` span less its
``fault.attempt`` children (program spans, ``cellbench/progspans.py``).
None for a call with no attempt, and where the program has no spans."""

from cellbench import progspans


def read(r):
    calls = progspans.calls(r)
    if not calls:
        return None
    own = []
    for c in calls:
        attempts = [s for s in c.spans if s.name == "fault.attempt"
                    and s.parent == c.top.name]
        if c.top.name != "convolve.dispatch" or not attempts:
            return None
        own.append(c.top.end_ns - c.top.start_ns
                   - sum(s.end_ns - s.start_ns for s in attempts))
    return progspans.median_us(own)
