"""Wire codecs for the host transport.

Two frame families share the TCP substrate (ref: the reference mixes JSON
and hand-rolled byte layouts on one NIO channel,
``paxosutil/PaxosPacketDemultiplexerFast.java:1``):

* ``J`` frames — JSON control messages: host-channel deltas, client
  requests/responses, failure-detection pings, admin ops.
* ``D`` frames — packed engine blobs: sender id + tick + raw int32 leaf
  bytes in ``Blob._fields`` order (shapes are static per EngineConfig, so
  no per-leaf headers are needed — the reference's fixed-layout
  ``RequestPacket.toBytes`` idea applied to whole state arrays).  The
  kind byte doubles as the blob SCHEMA version (``B`` was the pre-tag
  layout; ``C`` the pre-compact all-int32 layout; ``D`` is the compact
  exec-anchored layout, ``ops/engine.py`` module docstring): a
  fixed-layout frame from a different schema must be dropped by kind,
  never parsed misaligned — a mixed-version node fails loudly instead
  of feeding misparsed ballots into consensus.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Optional, Tuple

import numpy as np

from ..ops.engine import Blob, EngineConfig, _leaf_shapes, blob_vec_len

_BHDR = struct.Struct(">cIQ")  # kind, sender, tick

# cross-node trace context (Dapper-style, obs/reqtrace.py): an OPTIONAL
# ``"tc": [trace_id, origin_node, hop]`` field on J-frame request bodies
# (client_request[_batch] items, forward/forward_batch, payload gossip).
# Absent = untraced; bodies without it are byte-identical to the
# pre-trace wire format.  The binary R/S frames carry the same triple in
# a fixed 13-byte layout (net/hot_codec.py).
TRACE_KEY = "tc"


def attach_trace(body: Dict, tc) -> Dict:
    """Stamp a trace context onto a request body (no-op when None)."""
    if tc is not None:
        body[TRACE_KEY] = [int(tc[0]), int(tc[1]), int(tc[2])]
    return body


def extract_trace(body: Dict):
    """-> (trace_id, origin, hop) or None; malformed contexts drop (a
    trace field must never break request handling)."""
    tc = body.get(TRACE_KEY)
    if not tc:
        return None
    try:
        return (int(tc[0]), int(tc[1]), int(tc[2]))
    except (TypeError, ValueError, IndexError, KeyError):
        return None


def bump_hop(tc):
    """The per-process-boundary hop increment (forwards re-stamp with
    this so the merged timeline orders hops causally even under clock
    skew)."""
    return None if tc is None else (tc[0], tc[1], tc[2] + 1)


def encode_json(kind: str, sender: int, body: Dict) -> bytes:
    env = {"k": kind, "s": sender, "b": body}
    return b"J" + json.dumps(env, separators=(",", ":")).encode("utf-8")


def decode_kind(payload: bytes) -> str:
    return payload[:1].decode("ascii", "replace")


def decode_json(payload: bytes) -> Tuple[str, int, Dict]:
    env = json.loads(payload[1:].decode("utf-8"))
    return env["k"], int(env["s"]), env["b"]


def blob_shapes(cfg: EngineConfig):
    # derived from the engine's leaf table so the per-leaf codec and the
    # packed-vector codec can never disagree on the wire layout
    return dict(_leaf_shapes(Blob._fields, cfg))


def encode_blob(sender: int, tick: int, blob: Blob) -> bytes:
    parts = [_BHDR.pack(b"D", sender, tick)]
    for leaf in blob:
        parts.append(np.asarray(leaf, np.int32).tobytes())
    return b"".join(parts)


def encode_blob_vec(sender: int, tick: int, vec: np.ndarray) -> bytes:
    """Packed-vector fast path: `vec` is already the frame body (leaf
    C-order ravels in ``Blob._fields`` order — identical bytes to
    :func:`encode_blob`).  The body is copied once, straight into the
    frame (no ``tobytes`` copy to concatenate)."""
    body = np.ascontiguousarray(vec, np.int32)
    return b"".join((_BHDR.pack(b"D", sender, tick), memoryview(body)))


def decode_blob_vec(
    payload: bytes, cfg: EngineConfig
) -> Tuple[int, int, np.ndarray]:
    """Zero-split decode for the packed tick path: the frame body IS the
    [N] gathered-row vector.  Same size check as :func:`decode_blob`."""
    kind, sender, tick = _BHDR.unpack_from(payload, 0)
    if kind != b"D":
        raise ValueError(
            f"blob frame schema {kind!r} != expected b'D' "
            "(mixed-version peer; refusing to parse)"
        )
    n = blob_vec_len(cfg)
    if len(payload) != _BHDR.size + 4 * n:
        raise ValueError(
            f"blob frame size {len(payload)} != expected "
            f"{_BHDR.size + 4 * n} (peer blob-schema/config mismatch)"
        )
    return sender, tick, np.frombuffer(payload, np.int32, offset=_BHDR.size)


def decode_blob(payload: bytes, cfg: EngineConfig) -> Tuple[int, int, Blob]:
    kind, sender, tick = _BHDR.unpack_from(payload, 0)
    if kind != b"D":
        raise ValueError(
            f"blob frame schema {kind!r} != expected b'D' "
            "(mixed-version peer; refusing to parse)"
        )
    shapes = blob_shapes(cfg)
    expect = _BHDR.size + 4 * sum(int(np.prod(s)) for s in shapes.values())
    if len(payload) != expect:
        # fixed-layout frame: a size mismatch means the peer runs a
        # different blob schema (version skew) or a different
        # EngineConfig — misaligned leaves would feed garbage ballots
        # into consensus, so reject the frame outright
        raise ValueError(
            f"blob frame size {len(payload)} != expected {expect} "
            "(peer blob-schema/config mismatch)"
        )
    off = _BHDR.size
    leaves = []
    for name in Blob._fields:
        shape = shapes[name]
        n = int(np.prod(shape))
        arr = np.frombuffer(payload, np.int32, count=n, offset=off).reshape(shape)
        off += n * 4
        leaves.append(arr)
    return sender, tick, Blob(*leaves)
