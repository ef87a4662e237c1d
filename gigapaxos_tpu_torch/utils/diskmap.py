"""DiskMap — a capacity-bounded mapping that pages cold entries to disk.

API-parity target: ``utils/DiskMap`` (``DiskMap.java:97``): a map that
"pauses" idle entries to disk via commit/restore and transparently
restores them on access — the reference uses it for the journal's
per-group ``LogIndex`` and optionally the RC DB.  Here it bounds the RAM
of host-side per-group tables (e.g. the residency pause records: at the
1M-group design scale the paused-snapshot table must not live fully in
memory).

Spill files fan over hash-sharded subdirectories (``ab/<hash>.dm``, 256
shards): a flat directory holding millions of file-per-key spills
degrades directory operations on most filesystems and was the density
campaign's first casualty.  Entries remember the relative path they were
written under, so the layout is self-describing; construction cleans up
BOTH layouts (legacy flat files from an older incarnation and the
sharded tree), and a restore probes the sharded path first with a
flat-path fallback — an old spill dir never strands records.

Not a durability mechanism: the journal/checkpoint own persistence; a
DiskMap's spill directory is scratch owned by one process instance.
For the paused table at density scale, prefer
:class:`~gigapaxos_tpu_torch.utils.packedstore.PackedSpillStore` (segment
files, bounded inodes); this class remains the simple file-per-key
fallback (``PACKED_SPILL=false``).
"""

from __future__ import annotations

import hashlib
import json
import os
from collections import OrderedDict
from collections.abc import MutableMapping
from typing import Any, Callable, Iterable, Iterator, Optional


class DiskMap(MutableMapping):
    def __init__(
        self,
        directory: str,
        capacity: int = 65536,
        serialize: Callable[[Any], str] = lambda v: json.dumps(v),
        deserialize: Callable[[str], Any] = lambda s: json.loads(s),
    ):
        if capacity < 2:
            raise ValueError("capacity must be >= 2")
        self.dir = directory
        self.capacity = int(capacity)
        self._ser = serialize
        self._de = deserialize
        os.makedirs(directory, exist_ok=True)
        self._mem: "OrderedDict[Any, Any]" = OrderedDict()  # LRU: MRU last
        self._on_disk: dict = {}  # key -> relative spill path
        self._made_shards: set = set()  # shard subdirs known to exist
        # clear stale spills from a previous incarnation (scratch
        # semantics) — the legacy flat layout AND the sharded tree
        for f in os.listdir(directory):
            p = os.path.join(directory, f)
            if f.endswith(".dm"):
                try:
                    os.remove(p)
                except OSError:
                    pass
            elif len(f) == 2 and os.path.isdir(p):
                for g in os.listdir(p):
                    if g.endswith(".dm"):
                        try:
                            os.remove(os.path.join(p, g))
                        except OSError:
                            pass

    # ---- spill machinery (commit/restore analog) -----------------------
    def _fname(self, key: Any) -> str:
        """Relative sharded spill path: ``ab/<hash>.dm`` (first hash
        byte = shard, 256 subdirs — bounds any one directory's entry
        count regardless of key count)."""
        h = hashlib.blake2b(repr(key).encode(), digest_size=12).hexdigest()
        return os.path.join(h[:2], f"{h}.dm")

    def _abspath(self, fname: str) -> str:
        """Resolve a recorded relative spill path, with a legacy
        flat-layout fallback (migration: a record written flat by an
        older layout is still found by its basename)."""
        p = os.path.join(self.dir, fname)
        if os.sep in fname and not os.path.exists(p):
            flat = os.path.join(self.dir, os.path.basename(fname))
            if os.path.exists(flat):
                return flat
        return p

    def _ensure_shard(self, fname: str) -> None:
        shard = os.path.dirname(fname)
        if shard and shard not in self._made_shards:
            os.makedirs(os.path.join(self.dir, shard), exist_ok=True)
            self._made_shards.add(shard)

    def _spill_one(self, key: Any) -> None:
        """Page one in-memory entry out.  Write-before-pop: a failed
        spill (ENOSPC) must not lose the entry — it stays in memory and
        the error surfaces to the caller."""
        value = self._mem[key]
        fname = self._fname(key)
        self._ensure_shard(fname)
        with open(os.path.join(self.dir, fname), "w",
                  encoding="utf-8") as f:
            f.write(self._ser(value))
        del self._mem[key]
        self._on_disk[key] = fname

    def _spill_many(self, keys: Iterable[Any]) -> None:
        """Batched spill: one pass, shard dirs created at most once each
        (the per-key makedirs probe was measurable at pause-burst
        scale)."""
        for key in keys:
            if key in self._mem:
                self._spill_one(key)

    def _spill_lru(self) -> None:
        """Page out the least-recently-used half (Deactivator batch)."""
        n = max(1, len(self._mem) - self.capacity // 2)
        self._spill_many(list(self._mem)[:n])

    def _restore(self, key: Any) -> Any:
        fname = self._on_disk.pop(key)
        path = self._abspath(fname)
        with open(path, "r", encoding="utf-8") as f:
            value = self._de(f.read())
        os.remove(path)
        self[key] = value  # promotes (and may re-spill others)
        return value

    # ---- MutableMapping ------------------------------------------------
    def __getitem__(self, key: Any) -> Any:
        if key in self._mem:
            self._mem.move_to_end(key)
            return self._mem[key]
        if key in self._on_disk:
            return self._restore(key)
        raise KeyError(key)

    def __setitem__(self, key: Any, value: Any) -> None:
        if key in self._on_disk:
            fname = self._on_disk.pop(key)
            try:
                os.remove(self._abspath(fname))
            except OSError:
                pass
        self._mem[key] = value
        self._mem.move_to_end(key)
        if len(self._mem) > self.capacity:
            self._spill_lru()

    def __delitem__(self, key: Any) -> None:
        if key in self._mem:
            del self._mem[key]
            return
        fname = self._on_disk.pop(key, None)
        if fname is None:
            raise KeyError(key)
        try:
            os.remove(self._abspath(fname))
        except OSError:
            pass

    def __contains__(self, key: Any) -> bool:
        return key in self._mem or key in self._on_disk

    def __iter__(self) -> Iterator:
        yield from list(self._mem)
        yield from list(self._on_disk)

    def __len__(self) -> int:
        return len(self._mem) + len(self._on_disk)

    def peek_items(self) -> Iterator:
        """(key, value) over everything WITHOUT promoting spilled entries
        (plain items() restores each spilled key into memory — a full
        iteration, e.g. for checkpointing, would defeat the RAM bound and
        churn every spill file)."""
        for key in list(self._mem):
            yield key, self._mem[key]
        for key, fname in list(self._on_disk.items()):
            with open(self._abspath(fname), "r",
                      encoding="utf-8") as f:
                yield key, self._de(f.read())

    def demote(self, key: Any) -> bool:
        """Explicitly page one entry out to disk NOW (hibernate support:
        the caller wants this entry's RAM back immediately instead of
        waiting for LRU pressure).  Returns False for unknown keys;
        already-spilled keys are left alone."""
        if key not in self._mem:
            return key in self._on_disk
        self._spill_one(key)
        return True

    def demote_batch(self, keys: Iterable[Any]) -> int:
        """Batched demote (pause-burst path): spill every given
        in-memory key; already-spilled keys count as demoted."""
        n = 0
        for key in keys:
            if key in self._mem:
                self._spill_one(key)
                n += 1
            elif key in self._on_disk:
                n += 1
        return n

    @property
    def n_in_memory(self) -> int:
        return len(self._mem)

    @property
    def n_on_disk(self) -> int:
        return len(self._on_disk)

    def stats(self) -> dict:
        return {
            "kind": "file-per-key",
            "in_memory": len(self._mem),
            "on_disk": len(self._on_disk),
        }
