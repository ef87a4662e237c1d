"""Share of the traced window, in %, in which no kernel, copy or fill ran
on the card (the profiler's timeline)."""


def read(tl, ctx):
    window = tl.window_us()
    if window <= 0 or not tl.in_window():
        return None
    return 100.0 * (1.0 - tl.busy_us() / window)
