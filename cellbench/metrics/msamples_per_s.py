"""``msamples_per_s``: the input samples of every call completed in the
window, over the window's seconds, in millions (host clock)."""


def read(r):
    return r.calls * r.samples_per_call / r.window.seconds / 1e6
