"""The stacked face's share of its roofline, in %: the least time the
face's calls in the traced window need at the card's published memory
rate (``reference/roofline.py``: one count for the face whatever route
implements it) over the device time of every kernel they launched (the
profiler's trace)."""

from gpbench.reference.roofline import traced_share


def read(tl, ctx):
    return traced_share(tl, ctx, "stacked")
