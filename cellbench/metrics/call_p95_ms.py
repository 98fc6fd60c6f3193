"""``call_p95_ms``: the 95th percentile of the window's calls, each
from its start to the end of the wait for the card (host clock)."""

import numpy as np


def read(r):
    w = r.window
    return float(np.percentile(w.c - w.a, 95)) / 1e6
