"""Binary client-plane hot-path codec ('R'/'S' frames).

The serving hot path carries two frame shapes at rate: client request
batches in and response batches out.  As JSON ('J' frames) each costs a
``json.dumps``/``json.loads`` plus a per-item dict — at capacity that
per-request constant IS the system throughput (the reference sidesteps
it with hand-rolled byte layouts, ``RequestPacket.toBytes`` /
``PaxosPacketDemultiplexerFast.java``).  These fixed-layout frames
replace it:

* ``R`` — request batch: ``sender:i32 count:u32`` then per item
  ``rid:u64 flags:u8 name_len:u16 value_len:u32 name value [trace]``
  (flags bit0 = stop, bit1 = trace context present);
* ``S`` — response batch: ``sender:i32 count:u32`` then per item
  ``rid:u64 err:u8 has:u8 name_len:u16 resp_len:u32 name resp [trace]``
  (has bit0 = response present, bit1 = trace context present).

``[trace]`` is the OPTIONAL cross-node trace context
(``obs/reqtrace.py``): ``tid:u64 origin:i32 hop:u8`` appended after the
item's payload only when the bit is set.  Untraced items carry no extra
bytes, so frames without trace contexts are byte-identical to the
pre-trace wire format (pinned by the golden-bytes tests).  A traced
request item is the 5-tuple ``(rid, name, value, stop, (tid, origin,
hop))``; a traced response dict carries ``"tc": [tid, origin, hop]``.

Both directions have TWO implementations producing byte-identical wire
frames: the native library (``native/gp_codec.cc`` via ctypes — the
scan/pack runs with the GIL released, so transport threads progress
while the tick thread holds the state lock) and pure Python ``struct``
(``GP_NO_NATIVE=1`` or no toolchain).  Parity is pinned by golden-bytes
and round-trip tests (``tests/test_hot_codec.py``); :func:`status`
reports which implementation is live so a silently missing toolchain
can never masquerade as the fast path (it shows up in the ``stats``
admin op).

Error strings travel as codes (the table below); a response carrying an
error outside the table cannot ride an ``S`` frame — the caller falls
back to the JSON path for that batch (correctness first).
"""

from __future__ import annotations

import ctypes
import struct
from typing import Dict, List, Optional, Tuple

_ENV = struct.Struct("<iI")   # sender:i32, count:u32 (after the kind byte)
_R_ITEM = struct.Struct("<QBHI")   # rid, flags, name_len, value_len
_S_ITEM = struct.Struct("<QBBHI")  # rid, err, has, name_len, resp_len
_TC = struct.Struct("<QiB")        # trace tail: tid, origin, hop

STOP_FLAG = 0x01
TRACE_FLAG = 0x02  # in R `flags` and S `has`: 13-byte trace tail follows

# error-string table (the only errors the serving path emits); 0 = none
ERR_CODES: Dict[str, int] = {"overload": 1, "unknown_name": 2,
                             "exhausted": 3}
ERR_STRINGS: Dict[int, str] = {v: k for k, v in ERR_CODES.items()}

# request item: (request_id, name, value, stop) — or the traced 5-tuple
# (request_id, name, value, stop, (tid, origin, hop))
ReqItem = Tuple


def _lib() -> Optional[ctypes.CDLL]:
    from ..native import codec_lib

    return codec_lib()


def native_active() -> bool:
    return _lib() is not None


def status() -> Dict:
    """Which codec implementation is live (the ``stats`` admin-op row)."""
    return {
        "binary_frames": True,
        "native": native_active(),
        "impl": "gp_codec.so" if native_active() else "python-struct",
    }


# ---------------------------------------------------------------------------
# request batches ('R')
# ---------------------------------------------------------------------------
def encode_request_batch(sender: int, items: List[ReqItem]) -> bytes:
    lib = _lib()
    if lib is not None:
        return _encode_req_native(lib, sender, items)
    parts = [b"R", _ENV.pack(int(sender), len(items))]
    for item in items:
        rid, name, value, stop = item[:4]
        tc = item[4] if len(item) > 4 else None
        nb = name.encode("utf-8")
        vb = value.encode("utf-8")
        flags = (STOP_FLAG if stop else 0) | (TRACE_FLAG if tc else 0)
        parts.append(_R_ITEM.pack(int(rid), flags, len(nb), len(vb)))
        parts.append(nb)
        parts.append(vb)
        if tc:
            parts.append(_TC.pack(int(tc[0]), int(tc[1]), int(tc[2])))
    return b"".join(parts)


def _encode_req_native(lib, sender: int, items: List[ReqItem]) -> bytes:
    n = len(items)
    rids = (ctypes.c_uint64 * n)()
    flags = (ctypes.c_uint8 * n)()
    name_ptrs = (ctypes.c_char_p * n)()
    name_lens = (ctypes.c_uint16 * n)()
    val_ptrs = (ctypes.c_char_p * n)()
    val_lens = (ctypes.c_uint32 * n)()
    tids = (ctypes.c_uint64 * n)()
    origins = (ctypes.c_int32 * n)()
    hops = (ctypes.c_uint8 * n)()
    cap = 9 + 15 * n
    # the encoded bytes objects must outlive the call (c_char_p holds a
    # borrowed pointer) — keep them pinned in a list until pack returns
    pin = []
    for i, item in enumerate(items):
        rid, name, value, stop = item[:4]
        tc = item[4] if len(item) > 4 else None
        nb = name.encode("utf-8")
        vb = value.encode("utf-8")
        pin.append(nb)
        pin.append(vb)
        rids[i] = int(rid)
        flags[i] = (STOP_FLAG if stop else 0) | (TRACE_FLAG if tc else 0)
        name_ptrs[i] = nb
        name_lens[i] = len(nb)
        val_ptrs[i] = vb
        val_lens[i] = len(vb)
        cap += len(nb) + len(vb)
        if tc:
            tids[i] = int(tc[0])
            origins[i] = int(tc[1])
            hops[i] = int(tc[2]) & 0xFF
            cap += _TC.size
    out = (ctypes.c_uint8 * cap)()
    wrote = lib.gpc_pack_req(
        out, cap, int(sender), n, rids, flags,
        name_ptrs, name_lens, val_ptrs, val_lens,
        tids, origins, hops,
    )
    if wrote < 0:  # cannot happen with the exact cap; belt and braces
        raise ValueError("gpc_pack_req: buffer overflow")
    return bytes(bytearray(out)[:wrote])


def decode_request_batch(payload: bytes) -> Tuple[int, List[ReqItem]]:
    """-> (sender, [(rid, name, value, stop[, tc]), ...]); raises
    ValueError on a malformed frame (the caller drops it loudly, like
    blob skew).  Traced items come back as 5-tuples with
    ``tc = (tid, origin, hop)``; untraced items stay 4-tuples."""
    lib = _lib()
    if lib is not None:
        return _decode_req_native(lib, payload)
    if len(payload) < 9 or payload[:1] != b"R":
        raise ValueError("malformed R frame")
    sender, count = _ENV.unpack_from(payload, 1)
    off = 9
    items: List[ReqItem] = []
    try:
        for _ in range(count):
            rid, flags, nl, vl = _R_ITEM.unpack_from(payload, off)
            off += _R_ITEM.size
            name = payload[off:off + nl].decode("utf-8")
            off += nl
            value = payload[off:off + vl].decode("utf-8")
            off += vl
            if off > len(payload):
                raise ValueError("truncated R frame")
            if flags & TRACE_FLAG:
                tid, origin, hop = _TC.unpack_from(payload, off)
                off += _TC.size
                items.append((rid, name, value, bool(flags & STOP_FLAG),
                              (tid, origin, hop)))
            else:
                items.append((rid, name, value, bool(flags & STOP_FLAG)))
    except struct.error as e:
        raise ValueError(f"malformed R frame: {e}") from e
    if off != len(payload):
        raise ValueError("R frame has trailing bytes")
    return sender, items


def _decode_req_native(lib, payload: bytes) -> Tuple[int, List[ReqItem]]:
    if len(payload) < 9:
        raise ValueError("malformed R frame")
    (count,) = struct.unpack_from("<I", payload, 5)
    if count > (len(payload) - 9) // _R_ITEM.size + 1:
        # declared count can't fit in the frame: reject BEFORE sizing the
        # index buffer off an attacker-controlled u32
        raise ValueError("malformed R frame (count)")
    idx = (ctypes.c_int64 * (9 * max(1, count)))()
    n = lib.gpc_req_index(payload, len(payload), idx, count)
    if n < 0:
        raise ValueError("malformed R frame (native index)")
    (sender,) = struct.unpack_from("<i", payload, 1)
    items: List[ReqItem] = []
    for i in range(n):
        o = i * 9
        no, nl, vo, vl = idx[o + 2], idx[o + 3], idx[o + 4], idx[o + 5]
        base = (
            idx[o], payload[no:no + nl].decode("utf-8"),
            payload[vo:vo + vl].decode("utf-8"),
            bool(idx[o + 1] & STOP_FLAG),
        )
        if idx[o + 1] & TRACE_FLAG:
            base += ((idx[o + 6], int(idx[o + 7]), int(idx[o + 8])),)
        items.append(base)
    return sender, items


# ---------------------------------------------------------------------------
# response batches ('S')
# ---------------------------------------------------------------------------
def encodable_response(item: Dict) -> bool:
    """True when this response item fits the fixed layout (known error
    code, string-or-None response)."""
    err = item.get("error")
    if err is not None and err not in ERR_CODES:
        return False
    resp = item.get("response")
    return resp is None or isinstance(resp, str)


def encode_response_batch(sender: int, items: List[Dict]) -> bytes:
    """``items`` are the server's buffered response dicts
    (request_id/response/name[/error][/tc]).  Caller must pre-screen with
    :func:`encodable_response` and take the JSON path otherwise."""
    lib = _lib()
    if lib is not None:
        return _encode_resp_native(lib, sender, items)
    parts = [b"S", _ENV.pack(int(sender), len(items))]
    for item in items:
        nb = str(item.get("name") or "").encode("utf-8")
        resp = item.get("response")
        tc = item.get("tc")
        rb = b"" if resp is None else resp.encode("utf-8")
        parts.append(_S_ITEM.pack(
            int(item["request_id"]),
            ERR_CODES.get(item.get("error") or "", 0),
            (0 if resp is None else 1) | (TRACE_FLAG if tc else 0),
            len(nb), len(rb),
        ))
        parts.append(nb)
        parts.append(rb)
        if tc:
            parts.append(_TC.pack(int(tc[0]), int(tc[1]), int(tc[2])))
    return b"".join(parts)


def _encode_resp_native(lib, sender: int, items: List[Dict]) -> bytes:
    n = len(items)
    rids = (ctypes.c_uint64 * n)()
    errs = (ctypes.c_uint8 * n)()
    has = (ctypes.c_uint8 * n)()
    name_ptrs = (ctypes.c_char_p * n)()
    name_lens = (ctypes.c_uint16 * n)()
    resp_ptrs = (ctypes.c_char_p * n)()
    resp_lens = (ctypes.c_uint32 * n)()
    tids = (ctypes.c_uint64 * n)()
    origins = (ctypes.c_int32 * n)()
    hops = (ctypes.c_uint8 * n)()
    cap = 9 + 16 * n
    pin = []
    for i, item in enumerate(items):
        nb = str(item.get("name") or "").encode("utf-8")
        resp = item.get("response")
        tc = item.get("tc")
        rb = b"" if resp is None else resp.encode("utf-8")
        pin.append(nb)
        pin.append(rb)
        rids[i] = int(item["request_id"])
        errs[i] = ERR_CODES.get(item.get("error") or "", 0)
        has[i] = (0 if resp is None else 1) | (TRACE_FLAG if tc else 0)
        name_ptrs[i] = nb
        name_lens[i] = len(nb)
        resp_ptrs[i] = rb
        resp_lens[i] = len(rb)
        cap += len(nb) + len(rb)
        if tc:
            tids[i] = int(tc[0])
            origins[i] = int(tc[1])
            hops[i] = int(tc[2]) & 0xFF
            cap += _TC.size
    out = (ctypes.c_uint8 * cap)()
    wrote = lib.gpc_pack_resp(
        out, cap, int(sender), n, rids, errs, has,
        name_ptrs, name_lens, resp_ptrs, resp_lens,
        tids, origins, hops,
    )
    if wrote < 0:
        raise ValueError("gpc_pack_resp: buffer overflow")
    return bytes(bytearray(out)[:wrote])


def decode_response_batch(payload: bytes) -> Tuple[int, List[Dict]]:
    """-> (sender, [response dicts shaped like the JSON path's]), so the
    client's ``_on_response`` consumes either wire format unchanged.
    Traced responses carry ``"tc": [tid, origin, hop]``."""
    lib = _lib()
    if lib is not None:
        return _decode_resp_native(lib, payload)
    if len(payload) < 9 or payload[:1] != b"S":
        raise ValueError("malformed S frame")
    sender, count = _ENV.unpack_from(payload, 1)
    off = 9
    items: List[Dict] = []
    try:
        for _ in range(count):
            rid, err, has, nl, rl = _S_ITEM.unpack_from(payload, off)
            off += _S_ITEM.size
            name = payload[off:off + nl].decode("utf-8")
            off += nl
            resp = payload[off:off + rl].decode("utf-8") if has & 1 else None
            off += rl
            if off > len(payload):
                raise ValueError("truncated S frame")
            item: Dict = {"request_id": rid, "response": resp, "name": name}
            if err:
                item["error"] = ERR_STRINGS[err]
            if has & TRACE_FLAG:
                tid, origin, hop = _TC.unpack_from(payload, off)
                off += _TC.size
                item["tc"] = [tid, origin, hop]
            items.append(item)
    except struct.error as e:
        raise ValueError(f"malformed S frame: {e}") from e
    if off != len(payload):
        raise ValueError("S frame has trailing bytes")
    return sender, items


def _decode_resp_native(lib, payload: bytes) -> Tuple[int, List[Dict]]:
    if len(payload) < 9:
        raise ValueError("malformed S frame")
    (count,) = struct.unpack_from("<I", payload, 5)
    if count > (len(payload) - 9) // _S_ITEM.size + 1:
        raise ValueError("malformed S frame (count)")
    idx = (ctypes.c_int64 * (10 * max(1, count)))()
    n = lib.gpc_resp_index(payload, len(payload), idx, count)
    if n < 0:
        raise ValueError("malformed S frame (native index)")
    (sender,) = struct.unpack_from("<i", payload, 1)
    items: List[Dict] = []
    for i in range(n):
        o = i * 10
        no, nl, ro, rl = idx[o + 3], idx[o + 4], idx[o + 5], idx[o + 6]
        item: Dict = {
            "request_id": idx[o],
            "response": (
                payload[ro:ro + rl].decode("utf-8")
                if idx[o + 2] & 1 else None
            ),
            "name": payload[no:no + nl].decode("utf-8"),
        }
        if idx[o + 1]:
            item["error"] = ERR_STRINGS[int(idx[o + 1])]
        if idx[o + 2] & TRACE_FLAG:
            item["tc"] = [idx[o + 7], int(idx[o + 8]), int(idx[o + 9])]
        items.append(item)
    return sender, items
