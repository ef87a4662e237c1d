"""Kernels the step faces launched, per step (the profiler's trace)."""


def read(tl, ctx):
    kernels = tl.face_kernels()
    if not kernels or not ctx["steps"]:
        return None
    return len(kernels) / ctx["steps"]
