"""``setup_s``: from the process's start to the first timed call:
imports, the card's context, the kernels' library (built on a
checkout's first run), the operands and the warm-up (host clock)."""


def read(r):
    return r.setup_s
