"""The bytes a step face must move, and the card's published peaks.

The count is the work the FACE asks for, whatever route implements it:
each input read once and each output written once, all int32.  A blob
that replicas exchange inside one call (the stacked face's blob matrix,
or a cluster's shared memory) is an intermediate value and is not
counted, so a share of the roofline moves only when the time moves.

Per group, in int32 words (G groups, window W, K request lanes, R
replicas, N substeps in one call):

* state: 12 [G] and 7 [G, W] leaves, read once and written once;
* out row of a substep: 6 [G] and 3 [G, W] leaves;
* blob: 4 [G] and 4 [G, W] leaves;
* requests: K words a substep; want: one byte; heard: R bytes a replica.
"""

from __future__ import annotations

STATE_WORDS = lambda W: 12 + 7 * W      # noqa: E731
OUT_WORDS = lambda W: 6 + 3 * W         # noqa: E731
BLOB_WORDS = lambda W: 4 + 4 * W        # noqa: E731

# published device-memory rates, bytes/s, by a fragment of the card's name
# (NVIDIA data sheets; the dense rate at the full power limit)
PEAK_BYTES_PER_S = (
    ("H100 NVL", 3.9e12),
    ("H100 PCIe", 2.0e12),
    ("H100", 3.35e12),        # H100 SXM5 80GB HBM3
)


def peak_bytes_per_s(card_name: str) -> float:
    for fragment, rate in PEAK_BYTES_PER_S:
        if fragment in card_name:
            return rate
    raise ValueError(f"no published memory rate for {card_name!r}")


def stacked_bytes(G: int, W: int, K: int, R: int, N: int = 1) -> int:
    """One call of the stacked face: N substeps of all R replicas.  Every
    replica's state is read and written once, its N request tiles read,
    its N out rows written, its want byte read; the [R, R] heard matrix
    read once."""
    words = 2 * STATE_WORDS(W) + N * K + N * OUT_WORDS(W)
    return R * G * (4 * words + 1) + R * R


def packed_bytes(G: int, W: int, K: int, R: int, N: int = 1,
                 heat: bool = True) -> int:
    """One call of the packed face (one replica): its state read and
    written, the [R, NB] gathered rows read, N request tiles read, N out
    rows written, the fresh blob written, the heat accumulator read and
    written, the want byte per group and the R heard bytes."""
    words = (2 * STATE_WORDS(W) + R * BLOB_WORDS(W) + N * K + N * OUT_WORDS(W)
             + BLOB_WORDS(W) + (2 if heat else 0))
    return G * (4 * words + 1) + R


def face_bytes(face: str, G: int, W: int, K: int, R: int, N: int = 1,
               heat: bool = True) -> int:
    if face == "stacked":
        return stacked_bytes(G, W, K, R, N)
    if face == "packed_host":
        return packed_bytes(G, W, K, R, N, heat)
    raise ValueError(f"unknown face {face!r}")


def traced_share(tl, ctx, face: str):
    """A face's share of its roofline over a traced window, in %: the
    bytes its ``ctx["calls"]`` calls need at the card's published rate,
    over the device time of the kernels they launched; None where the
    window holds none."""
    kernels = tl.face_kernels()
    if not kernels or not ctx["calls"]:
        return None
    kernel_s = sum(o.end - o.start for o in kernels) * 1e-6
    need = ctx["calls"] * face_bytes(face, ctx["G"], ctx["W"], ctx["K"], ctx["R"],
                                     ctx["N"], ctx["heat"])
    return 100.0 * need / peak_bytes_per_s(ctx["card"]) / kernel_s
