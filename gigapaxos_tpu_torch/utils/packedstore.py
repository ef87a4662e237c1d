"""PackedSpillStore — segment-file spill store for the paused-group table.

The file-per-key :class:`~gigapaxos_tpu_torch.utils.diskmap.DiskMap` layout
collapses at density scale: a cold tail of millions of paused names
costs millions of inodes, one open/write/close per spill, and random
reads on wake.  This store keeps the same capacity-bounded mapping
contract (LRU memory tier, explicit ``demote``, ``peek_items``) but
pages cold entries into **recency-ordered segment files**:

* spills APPEND length+CRC framed records to the current tail segment,
  so a pause burst is one sequential write stream, not N file creates;
* segments fan over hashed subdirectories (``SPILL_SUBDIRS``) so no
  directory ever holds more than segments/subdirs entries — bounded
  inodes regardless of key count (one segment covers thousands of keys);
* the in-RAM index is ``key -> (segment, offset, length)`` — the only
  per-paused-name RAM cost, measured by ``footprint_probe.py --paused``;
* wakes of names paused together (the recency pattern: a restart hot
  set, a rotating Zipfian head) read one segment sequentially —
  ``restore_batch`` sorts its reads by (segment, offset);
* deleting/restoring marks records dead; a segment whose dead fraction
  crosses ``compact_ratio`` is compacted (live records re-appended to
  the tail, file unlinked), so disk stays O(live records).

Not a durability mechanism — exactly like DiskMap, the spill directory
is scratch owned by one process incarnation (the journal's PAUSE blocks
are the durable copy); stale contents are wiped at construction.  A
torn tail (failed append: ENOSPC, crash mid-write) can therefore only
be produced by THIS process, and the append path truncates back to the
last good offset so one failed spill never corrupts its segment.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import zlib
from collections import OrderedDict
from collections.abc import MutableMapping
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Tuple

# record frame: u32 payload length, u32 crc32(payload), payload bytes
_HDR = struct.Struct("<II")


class SpillCorruption(KeyError):
    """A spilled record failed its CRC/length check on read."""


def _key_to_wire(key: Any):
    """JSON-stable form of a key (tuples round-trip as lists)."""
    return list(key) if isinstance(key, tuple) else key


def _key_from_wire(k: Any):
    return tuple(k) if isinstance(k, list) else k


class PackedSpillStore(MutableMapping):
    def __init__(
        self,
        directory: str,
        capacity: int = 65536,
        serialize: Callable[[Any], str] = lambda v: json.dumps(v),
        deserialize: Callable[[str], Any] = lambda s: json.loads(s),
        segment_bytes: int = 4 * 1024 * 1024,
        compact_ratio: float = 0.5,
        subdirs: int = 64,
    ):
        if capacity < 2:
            raise ValueError("capacity must be >= 2")
        self.dir = directory
        self.capacity = int(capacity)
        self._ser = serialize
        self._de = deserialize
        self.segment_bytes = max(4096, int(segment_bytes))
        self.compact_ratio = min(1.0, max(0.05, float(compact_ratio)))
        self.subdirs = max(1, int(subdirs))
        self._mem: "OrderedDict[Any, Any]" = OrderedDict()  # LRU: MRU last
        # key -> (segment id, payload offset, payload length)
        self._index: Dict[Any, Tuple[int, int, int]] = {}
        # segment id -> {"live": n, "dead": n, "bytes": n}
        self._segments: Dict[int, Dict[str, int]] = {}
        self._seg_id = 0          # current tail segment
        self._tail: Optional[Any] = None  # open append handle
        self._tail_off = 0        # committed end of the tail segment
        self.compactions = 0      # lifetime compacted segments (stats)
        # scratch semantics: wipe any previous incarnation's spills —
        # both this layout and a legacy flat/sharded DiskMap layout (a
        # deployment switching PACKED_SPILL reuses the same directory)
        if os.path.isdir(directory):
            for entry in os.listdir(directory):
                p = os.path.join(directory, entry)
                try:
                    if os.path.isdir(p):
                        shutil.rmtree(p)
                    elif entry.endswith((".dm", ".seg")):
                        os.remove(p)
                except OSError:
                    pass
        os.makedirs(directory, exist_ok=True)

    # ---- segment plumbing ---------------------------------------------
    def _seg_path(self, seg: int) -> str:
        sub = os.path.join(self.dir, f"{seg % self.subdirs:02x}")
        return os.path.join(sub, f"seg{seg:08d}.seg")

    def _open_tail(self):
        if self._tail is None:
            path = self._seg_path(self._seg_id)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            self._tail = open(path, "ab")
            self._tail_off = self._tail.tell()
            self._segments.setdefault(
                self._seg_id, {"live": 0, "dead": 0, "bytes": self._tail_off}
            )
        return self._tail

    def _roll_if_full(self) -> None:
        if self._tail_off >= self.segment_bytes:
            if self._tail is not None:
                self._tail.close()
                self._tail = None
            self._seg_id += 1
            self._tail_off = 0

    def _append_one(self, key: Any, value: Any) -> None:
        """Append one record to the tail.  Write-before-pop with torn-
        tail repair: on ANY failure the segment truncates back to the
        committed offset and the entry stays in memory — a failed spill
        surfaces to the caller without corrupting the segment."""
        payload = self._ser([_key_to_wire(key), value]).encode("utf-8")
        f = self._open_tail()
        try:
            f.write(_HDR.pack(len(payload), zlib.crc32(payload)))
            f.write(payload)
            f.flush()
        except OSError:
            # torn tail: drop the partial record so later appends start
            # at a clean frame boundary
            try:
                f.truncate(self._tail_off)
            except OSError:
                pass
            raise
        off = self._tail_off + _HDR.size
        self._index[key] = (self._seg_id, off, len(payload))
        self._tail_off = off + len(payload)
        seg = self._segments[self._seg_id]
        seg["live"] += 1
        seg["bytes"] = self._tail_off
        del self._mem[key]
        self._roll_if_full()

    def _read_record(self, seg: int, off: int, length: int) -> Any:
        with open(self._seg_path(seg), "rb") as f:
            f.seek(off - _HDR.size)
            hdr = f.read(_HDR.size)
            payload = f.read(length)
        if len(hdr) != _HDR.size or len(payload) != length:
            raise SpillCorruption(f"torn record in segment {seg} @ {off}")
        want_len, want_crc = _HDR.unpack(hdr)
        if want_len != length or zlib.crc32(payload) != want_crc:
            raise SpillCorruption(f"corrupt record in segment {seg} @ {off}")
        k, value = self._de(payload.decode("utf-8"))
        return _key_from_wire(k), value

    def _scan_segment(self, seg_id: int):
        """Yield (key, value, payload offset) for every intact record in
        a segment, in file order; stops cleanly at a torn tail."""
        try:
            f = open(self._seg_path(seg_id), "rb")
        except OSError:
            return
        with f:
            pos = 0
            while True:
                hdr = f.read(_HDR.size)
                if len(hdr) < _HDR.size:
                    return
                length, crc = _HDR.unpack(hdr)
                payload = f.read(length)
                if len(payload) < length or zlib.crc32(payload) != crc:
                    return  # torn tail
                k, value = self._de(payload.decode("utf-8"))
                yield _key_from_wire(k), value, pos + _HDR.size
                pos += _HDR.size + length

    def _mark_dead(self, key: Any) -> None:
        seg_id, _off, _len = self._index.pop(key)
        seg = self._segments.get(seg_id)
        if seg is None:
            return
        seg["live"] -= 1
        seg["dead"] += 1
        self._maybe_compact(seg_id)

    def _maybe_compact(self, seg_id: int) -> None:
        """Rewrite a dead-heavy NON-tail segment: live records re-append
        to the tail (they become the most recent stratum — they were
        touched last), the file unlinks.  O(segment) per trigger,
        amortized by the ratio gate."""
        if seg_id == self._seg_id:
            return  # never compact the open tail in place
        seg = self._segments.get(seg_id)
        if seg is None:
            return
        total = seg["live"] + seg["dead"]
        if total == 0 or seg["dead"] / total < self.compact_ratio:
            return
        # ONE sequential scan of the segment (dead records skip by frame,
        # never an O(index) sweep): a record is live iff the index still
        # points at its offset
        for key, value, off in self._scan_segment(seg_id):
            ent = self._index.get(key)
            if ent is None or ent[0] != seg_id or ent[1] != off:
                continue  # dead, or a newer copy lives elsewhere
            # stage through memory so _append_one's bookkeeping applies
            self._mem[key] = value
            del self._index[key]
            self._append_one(key, value)
        try:
            os.remove(self._seg_path(seg_id))
        except OSError:
            pass
        del self._segments[seg_id]
        self.compactions += 1

    # ---- spill / restore ----------------------------------------------
    def _spill_lru(self) -> None:
        """Page out the least-recently-used half (Deactivator batch) as
        one sequential append run."""
        n = max(1, len(self._mem) - self.capacity // 2)
        self.demote_batch(list(self._mem)[:n])

    def demote(self, key: Any) -> bool:
        """Page one entry out NOW (hibernate support).  Unknown keys
        return False; already-spilled keys are left alone."""
        if key not in self._mem:
            return key in self._index
        self._append_one(key, self._mem[key])
        return True

    def demote_batch(self, keys: Iterable[Any]) -> int:
        """Batched demote: one sequential append run over the tail
        segment(s) — the pause-burst fast path."""
        n = 0
        for key in keys:
            if key in self._mem:
                self._append_one(key, self._mem[key])
                n += 1
            elif key in self._index:
                n += 1
        return n

    def _restore(self, key: Any) -> Any:
        seg, off, ln = self._index[key]
        _k, value = self._read_record(seg, off, ln)
        self._mark_dead(key)
        self[key] = value  # promotes (and may re-spill others)
        return value

    def restore_batch(self, keys: List[Any]) -> Dict[Any, Any]:
        """Promote many spilled entries with sequential per-segment
        reads (sorted by (segment, offset)); in-memory keys ride along.
        Returns {key: value} for every key found; unknown keys are
        skipped.  ONE LRU spill pass runs at the end, so a wake burst
        does not thrash the memory tier per key."""
        out: Dict[Any, Any] = {}
        spilled = [(k, self._index[k]) for k in keys
                   if k not in self._mem and k in self._index]
        spilled.sort(key=lambda kv: (kv[1][0], kv[1][1]))
        for key, _stale in spilled:
            # re-resolve: a compaction triggered by an earlier restore in
            # THIS batch may have moved the record to the tail
            ent = self._index.get(key)
            if ent is None:
                continue
            seg, off, ln = ent
            _k, value = self._read_record(seg, off, ln)
            self._mark_dead(key)
            self._mem[key] = value
            self._mem.move_to_end(key)
            out[key] = value
        for key in keys:
            if key in self._mem and key not in out:
                self._mem.move_to_end(key)
                out[key] = self._mem[key]
        if len(self._mem) > self.capacity:
            self._spill_lru()
        return out

    # ---- MutableMapping ------------------------------------------------
    def __getitem__(self, key: Any) -> Any:
        if key in self._mem:
            self._mem.move_to_end(key)
            return self._mem[key]
        if key in self._index:
            return self._restore(key)
        raise KeyError(key)

    def __setitem__(self, key: Any, value: Any) -> None:
        if key in self._index:
            self._mark_dead(key)
        self._mem[key] = value
        self._mem.move_to_end(key)
        if len(self._mem) > self.capacity:
            self._spill_lru()

    def __delitem__(self, key: Any) -> None:
        if key in self._mem:
            del self._mem[key]
            return
        if key not in self._index:
            raise KeyError(key)
        self._mark_dead(key)

    def __contains__(self, key: Any) -> bool:
        return key in self._mem or key in self._index

    def __iter__(self) -> Iterator:
        yield from list(self._mem)
        yield from list(self._index)

    def __len__(self) -> int:
        return len(self._mem) + len(self._index)

    def peek_items(self) -> Iterator:
        """(key, value) over everything WITHOUT promoting spilled
        entries (checkpoint-style full iteration must not churn the
        memory tier); spilled records read in (segment, offset) order."""
        for key in list(self._mem):
            yield key, self._mem[key]
        for key, (seg, off, ln) in sorted(
            self._index.items(), key=lambda kv: (kv[1][0], kv[1][1])
        ):
            _k, value = self._read_record(seg, off, ln)
            yield key, value

    # ---- stats ---------------------------------------------------------
    @property
    def n_in_memory(self) -> int:
        return len(self._mem)

    @property
    def n_on_disk(self) -> int:
        return len(self._index)

    def stats(self) -> Dict[str, Any]:
        live = sum(s["live"] for s in self._segments.values())
        dead = sum(s["dead"] for s in self._segments.values())
        disk = sum(s["bytes"] for s in self._segments.values())
        return {
            "kind": "packed",
            "in_memory": len(self._mem),
            "on_disk": len(self._index),
            "segments": len(self._segments),
            "live_records": live,
            "dead_records": dead,
            "disk_bytes": disk,
            "bytes_per_record": round(disk / live, 1) if live else 0.0,
            "compactions": self.compactions,
        }

    def close(self) -> None:
        if self._tail is not None:
            self._tail.close()
            self._tail = None
