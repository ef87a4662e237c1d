"""The packed face's share of its roofline, in %: the least time the R
actives' calls in the traced window need at the card's published memory
rate (``reference/roofline.py``) over the device time of every kernel
they launched (the profiler's trace).  The uploads and readbacks are
copies, in ``copy_ms.wire``."""

from gpbench.reference.roofline import traced_share


def read(tl, ctx):
    return traced_share(tl, ctx, "packed_host")
