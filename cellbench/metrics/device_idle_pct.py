"""``device_idle_pct``: the share of the traced window, from the first
call's start to the last call's end, in which no kernel, copy or memset
ran on the card: the union of CUPTI's records (device trace)."""


def read(r):
    if r.records is None:
        return None
    lo, hi = r.device_window()
    return 100.0 * (1.0 - r.busy_s() / ((hi - lo) / 1e9))
