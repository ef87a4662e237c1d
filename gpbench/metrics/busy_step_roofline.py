"""The stacked face's share of the roofline of its busy groups, in %: the
least time the traced window's busy group-steps need at the card's
published memory rate (``reference/busy_roofline.py``) over the device
time of every kernel the face's calls launched (the profiler's trace).
The load counts the busy group-steps on the card (``busy_group_steps``
in the trace context); None where it counts none."""

from gpbench.reference.busy_roofline import traced_busy_share


def read(tl, ctx):
    return traced_busy_share(tl, ctx)
