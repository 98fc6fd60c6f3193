"""``kernels_per_call``: CUPTI's kernel records over the window, over
the calls (device trace)."""


def read(r):
    if r.records is None:
        return None
    return sum(1 for rec in r.records if rec.kind == "kernel") / r.calls
