"""``op_roofline``: the least time a call's operation could take on
the card, over the device time its kernels, copies and memsets took a
call, in percent.  The least time is the larger of the operation's
least operations over the fp32 peak and its least bytes over the memory
rate (``cellbench/work.py``), whatever route runs it (device trace)."""

from cellbench import work


def read(r):
    if not r.records:
        return None
    device_ms = sum(rec.end - rec.start for rec in r.records) / 1e6
    if device_ms <= 0:
        return None
    bound_ms, _ = work.fp32_bound(*r.work)
    return 100.0 * bound_ms * r.calls / device_ms
