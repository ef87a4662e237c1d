"""The bytes a step must move for the groups that had work in it.

A group is busy in a step when its coordinator was offered a proposal or
one of its replicas committed a slot.  Every correct step has to read
and write a busy group's state, read its request tile and want byte and
write its out row, the stacked face's per-group count
(``roofline.stacked_bytes``, linear in G); an idle group's share of that
work is not counted, so a step that rightly skips idle groups reads no
higher than a step that does all of them.
"""

from __future__ import annotations

from gpbench.reference.roofline import peak_bytes_per_s, stacked_bytes


def group_bytes(W: int, K: int, R: int) -> int:
    """The stacked face's bytes for one group (its R replicas), one step."""
    return stacked_bytes(1, W, K, R, 1) - R * R


def busy_bytes(busy_group_steps: int, W: int, K: int, R: int) -> int:
    return busy_group_steps * group_bytes(W, K, R)


def traced_busy_share(tl, ctx):
    """Share, in %, of the least time the busy group-steps of the traced
    window need at the card's published memory rate, over the device time
    of every kernel the face's calls launched; None where the window holds
    no face kernel or the load counted no busy group-step."""
    kernels = tl.face_kernels()
    busy = ctx.get("busy_group_steps")
    if not kernels or not busy:
        return None
    kernel_s = sum(o.end - o.start for o in kernels) * 1e-6
    need = busy_bytes(busy, ctx["W"], ctx["K"], ctx["R"])
    return 100.0 * need / peak_bytes_per_s(ctx["card"]) / kernel_s
