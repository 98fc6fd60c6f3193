"""``entry_host_us``: the median over the window's calls of the host
time from a call's start until the entry returns, before the wait for
the card: the entry, the ``runtime/faults`` guard, the operand checks,
the routing and the launches (host clock)."""

import numpy as np


def read(r):
    w = r.window
    return float(np.median(w.b - w.a)) / 1e3
