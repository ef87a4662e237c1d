"""Device time of the host-to-device and device-to-host copies, per
step, in ms (the profiler's trace)."""


def read(tl, ctx):
    copies = [o for o in tl.in_window() if o.kind == "copy"]
    if not copies or not ctx["steps"]:
        return None
    return sum(o.end - o.start for o in copies) * 1e-3 / ctx["steps"]
