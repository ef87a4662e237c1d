"""Host time inside the step faces' calls, per step, in ms, the uploads a
face makes of its host arguments included (the benchmark's own ``face``
span)."""


def read(tl, ctx):
    if not ctx["spans"].get("face") or not ctx["steps"]:
        return None
    return ctx["spans"]["face"] * 1e3 / ctx["steps"]
