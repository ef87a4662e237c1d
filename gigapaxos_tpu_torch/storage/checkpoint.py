"""Engine-state snapshots: one .npz of the batched arrays + a JSON sidecar.

The reference checkpoints *per group* into SQL tables (``checkpoint`` /
``prev_checkpoint``, ``SQLPaxosLogger.java:149-152``) because each group
is an object; here the whole engine is a handful of [G]/[G, W] arrays, so
a checkpoint is a single bulk snapshot and recovery a single bulk load
(the SURVEY §7 hard-part (d) answer).  App-level checkpoint strings
(``Replicable.checkpoint``) ride in the sidecar.

Torn-write protection: every snapshot embeds a **generation id** in both
the .npz (``__generation__`` array) and the sidecar (``"generation"``
key).  Both files of the new pair are fully written and fsynced to temp
names *before* any rename; the loader accepts any (snapshot, sidecar)
combination whose generation ids match, picking the highest generation —
so a crash between any two renames still leaves at least one matched
pair (the previous generation) discoverable.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

SNAP = "checkpoint.npz"
META = "checkpoint.meta.json"
PREV_SNAP = "prev_checkpoint.npz"
PREV_META = "prev_checkpoint.meta.json"

MANIFEST = "manifest.json"
PREV_MANIFEST = "prev_manifest.json"
SHARD_PREFIX = "ckpt_"

GEN_KEY = "__generation__"
ROWS_KEY = "__rows__"      # [lo, hi) row range a shard covers
APPS_KEY = "__apps__"      # uint8 view of the shard's app-state JSON


_LEGACY = -1  # marker for pre-generation files (no embedded id)


def _snap_generation(path: str) -> Optional[int]:
    """Generation embedded in a snapshot; _LEGACY if absent; None if unreadable."""
    try:
        with np.load(path) as z:
            if GEN_KEY in z.files:
                return int(z[GEN_KEY])
            return _LEGACY
    except Exception:
        return None


def _meta_generation(path: str) -> Optional[Tuple[int, Dict[str, Any]]]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            meta = json.load(f)
        return int(meta.get("generation", _LEGACY)), meta
    except Exception:
        return None


def save_checkpoint(
    directory: str,
    arrays: Dict[str, np.ndarray],
    meta: Dict[str, Any],
    n_shards: int = 1,
) -> None:
    """Atomically persist (arrays, meta), demoting the current pair to prev.

    Write order (each file fsynced before any rename):
      1. new snapshot  -> checkpoint.npz.tmp
      2. new sidecar   -> checkpoint.meta.json.tmp
      3. demote current pair to prev_*
      4. promote the tmp pair to checkpoint.*
    A crash at any point leaves >= 1 generation-matched pair on disk.
    """
    os.makedirs(directory, exist_ok=True)
    if n_shards > 1:
        save_checkpoint_sharded(directory, arrays, meta, n_shards)
        return
    snap = os.path.join(directory, SNAP)
    metaf = os.path.join(directory, META)

    gen = _next_generation(directory)

    meta = dict(meta)
    meta["generation"] = gen
    payload = dict(arrays)
    payload[GEN_KEY] = np.int64(gen)

    tmp = snap + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
        f.flush()
        os.fsync(f.fileno())
    tmpm = metaf + ".tmp"
    with open(tmpm, "w", encoding="utf-8") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())

    # Demote current -> prev ONLY as a generation-matched pair: a crash in
    # a previous save can leave an orphan current file (snapshot without
    # its sidecar or vice versa); demoting an orphan would overwrite half
    # of a still-valid prev pair and can strand the directory with zero
    # loadable checkpoints.  Orphans are deleted instead (they were never
    # loadable on their own).
    sg = _snap_generation(snap) if os.path.exists(snap) else None
    m = _meta_generation(metaf) if os.path.exists(metaf) else None
    mg = m[0] if m is not None else None
    if sg is not None and sg == mg:
        os.replace(snap, os.path.join(directory, PREV_SNAP))
        os.replace(metaf, os.path.join(directory, PREV_META))
    else:
        if os.path.exists(snap):
            os.remove(snap)
        if os.path.exists(metaf):
            os.remove(metaf)
    os.replace(tmp, snap)
    os.replace(tmpm, metaf)


def _load_checkpoint_legacy(
    directory: str,
) -> Optional[Tuple[int, Dict[str, np.ndarray], Dict[str, Any]]]:
    """Load the newest valid generation-matched single-pair checkpoint.

    Tries every (snapshot, sidecar) combination so that a crash between
    the demote/promote renames of :func:`save_checkpoint` (which can pair
    e.g. ``prev_checkpoint.npz`` with ``checkpoint.meta.json``) still
    finds the surviving pair; a sidecar is never silently combined with
    a snapshot from a different generation.  Returns (gen, arrays, meta).
    """
    snaps = {}   # name -> (gen, path)
    for name in (SNAP, PREV_SNAP):
        path = os.path.join(directory, name)
        if os.path.exists(path):
            g = _snap_generation(path)
            if g is not None:
                snaps[name] = (g, path)
    metas = {}   # name -> (gen, meta)
    for name in (META, PREV_META):
        path = os.path.join(directory, name)
        if os.path.exists(path):
            m = _meta_generation(path)
            if m is not None:
                metas[name] = m

    # Candidates: any cross combination whose EXPLICIT generations match;
    # legacy files (no embedded id) only pair name-aligned — current with
    # current, prev with prev — since 'both lack an id' proves nothing
    # about belonging together across names.
    candidates = []  # (gen, snap_path, meta)
    for sname, (sg, spath) in snaps.items():
        for mname, (mg, meta) in metas.items():
            aligned = (sname, mname) in ((SNAP, META), (PREV_SNAP, PREV_META))
            if sg == mg != _LEGACY or (sg == mg == _LEGACY and aligned):
                candidates.append((sg, sname == SNAP, spath, meta))
    # highest generation first; at equal gen prefer the current-named pair
    candidates.sort(key=lambda c: (c[0], c[1]), reverse=True)
    for gen, _cur, spath, meta in candidates:
        try:
            with np.load(spath) as z:
                arrays = {k: z[k] for k in z.files if k != GEN_KEY}
            return gen, arrays, meta
        except Exception:
            continue  # corrupt body despite readable header: try next pair
    return None


# ---------------------------------------------------------------------------
# Sharded checkpoints (the recovery plane's on-disk form).
#
# A snapshot is split into N group-range shards, each a self-contained
# .npz holding the engine-array rows [lo, hi) plus that range's app-state
# strings (as embedded JSON bytes), under a single ``manifest.json``
# naming every shard with its content hash.  Write order: every shard is
# fully written + fsynced under a generation-unique name, THEN the
# manifest lands atomically (tmp + fsync + demote current->prev +
# rename).  A torn shard (crash mid-write, bit rot) fails its manifest
# hash at load and recovery falls back to the previous generation's
# manifest — an earlier journal anchor, never a half-written snapshot.
# ---------------------------------------------------------------------------


def _shard_file(gen: int, idx: int) -> str:
    return f"{SHARD_PREFIX}g{gen:08d}_s{idx:04d}.npz"


def _manifest_at(directory: str, name: str) -> Optional[Dict[str, Any]]:
    try:
        with open(os.path.join(directory, name), "r", encoding="utf-8") as f:
            m = json.load(f)
        return m if isinstance(m, dict) and "shards" in m else None
    except Exception:
        return None


def _next_generation(directory: str) -> int:
    """1 + the highest generation visible in ANY format (legacy pairs and
    sharded manifests share one counter, so toggling the shard knob can
    never resurrect a stale older-format snapshot as 'newest')."""
    gen = 0
    for name in (SNAP, PREV_SNAP):
        g = _snap_generation(os.path.join(directory, name))
        if g is not None:
            gen = max(gen, g)
    for name in (META, PREV_META):
        m = _meta_generation(os.path.join(directory, name))
        if m is not None:
            gen = max(gen, m[0])
    for name in (MANIFEST, PREV_MANIFEST):
        man = _manifest_at(directory, name)
        if man is not None:
            gen = max(gen, int(man.get("generation", _LEGACY)))
    return gen + 1  # _LEGACY is -1, so legacy-only dirs start at 0+1


def _fsync_write(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def save_checkpoint_sharded(
    directory: str,
    arrays: Dict[str, np.ndarray],
    meta: Dict[str, Any],
    n_shards: int,
) -> None:
    """Persist (arrays, meta) as group-range shards + a hashed manifest.

    ``meta["app_states"]`` is lifted OUT of the manifest and sharded by
    each name's row (``meta["names"]``), so a lazy loader can parse one
    shard's app states without touching the rest; everything else in
    ``meta`` rides in the manifest verbatim."""
    os.makedirs(directory, exist_ok=True)
    gen = _next_generation(directory)
    meta = dict(meta)
    app_states = meta.pop("app_states", None) or {}
    names = meta.get("names") or {}

    G = 0
    for v in arrays.values():
        G = max(G, int(np.asarray(v).shape[0]))
    n_shards = max(1, min(int(n_shards), G or 1))
    bounds = [
        (G * i // n_shards, G * (i + 1) // n_shards) for i in range(n_shards)
    ]

    los = [lo for lo, _ in bounds]

    def shard_of(row: int) -> int:
        import bisect

        return max(0, bisect.bisect_right(los, int(row)) - 1)

    apps_by_shard: List[Dict[str, Any]] = [{} for _ in range(n_shards)]
    homeless: Dict[str, Any] = {}
    for nm, st in app_states.items():
        row = names.get(nm)
        if row is None:
            homeless[nm] = st  # unmapped state: keep it loadable anyway
        else:
            apps_by_shard[shard_of(int(row))][nm] = st
    if homeless:
        meta["app_states_unmapped"] = homeless

    shard_table = []
    for i, (lo, hi) in enumerate(bounds):
        payload: Dict[str, np.ndarray] = {
            k: np.asarray(v)[lo:hi] for k, v in arrays.items()
        }
        payload[GEN_KEY] = np.int64(gen)
        payload[ROWS_KEY] = np.array([lo, hi], np.int64)
        payload[APPS_KEY] = np.frombuffer(
            json.dumps(apps_by_shard[i], separators=(",", ":")).encode(
                "utf-8"
            ),
            np.uint8,
        )
        buf = io.BytesIO()
        np.savez(buf, **payload)
        data = buf.getvalue()
        fname = _shard_file(gen, i)
        tmp = os.path.join(directory, fname + ".tmp")
        _fsync_write(tmp, data)
        os.replace(tmp, os.path.join(directory, fname))
        shard_table.append({
            "file": fname, "lo": lo, "hi": hi,
            "sha256": hashlib.sha256(data).hexdigest(),
            "bytes": len(data),
        })

    manifest = {
        "generation": gen,
        "rows": G,
        "n_shards": n_shards,
        "journal_pos": meta.get("journal_pos"),
        "shards": shard_table,
        "meta": meta,
    }
    man_path = os.path.join(directory, MANIFEST)
    tmp = man_path + ".tmp"
    _fsync_write(tmp, json.dumps(manifest, separators=(",", ":")).encode(
        "utf-8"
    ))
    prev_gen = None
    cur = _manifest_at(directory, MANIFEST)
    if cur is not None:
        prev_gen = int(cur.get("generation", _LEGACY))
        os.replace(man_path, os.path.join(directory, PREV_MANIFEST))
    else:
        # a crash between the demote and promote renames leaves only
        # PREV_MANIFEST on disk — its generation must survive the GC
        # below, or the torn-shard fallback would point at deleted files
        prev = _manifest_at(directory, PREV_MANIFEST)
        if prev is not None:
            prev_gen = int(prev.get("generation", _LEGACY))
    os.replace(tmp, man_path)

    # GC shard files of generations older than the retained pair
    keep = {gen}
    if prev_gen is not None:
        keep.add(prev_gen)
    for fname in os.listdir(directory):
        # ".npz.tmp" too: a crash between write and rename orphans a
        # generation-unique tmp that no later save would ever overwrite
        if not (fname.startswith(SHARD_PREFIX)
                and fname.endswith((".npz", ".npz.tmp"))):
            continue
        try:
            g = int(fname[len(SHARD_PREFIX) + 1:len(SHARD_PREFIX) + 9])
        except ValueError:
            continue
        if g not in keep:
            try:
                os.remove(os.path.join(directory, fname))
            except OSError:
                pass


class CheckpointView:
    """A loaded checkpoint with per-shard lazy app-state parsing.

    ``arrays`` (the reassembled engine leaves) and ``meta`` are eager —
    they are needed before serving anything; the per-shard app-state
    JSON stays as raw bytes until :meth:`app_states` is asked for that
    shard (the recovery plane hydrates cold shards in the background)."""

    def __init__(
        self,
        generation: int,
        arrays: Dict[str, np.ndarray],
        meta: Dict[str, Any],
        shard_ranges: List[Tuple[int, int]],
        apps_raw: List[Optional[bytes]],
    ):
        self.generation = generation
        self.arrays = arrays
        self.meta = meta
        self.shard_ranges = shard_ranges
        self._apps_raw = apps_raw
        self._apps: List[Optional[Dict[str, Any]]] = [None] * len(apps_raw)

    @property
    def n_shards(self) -> int:
        return len(self.shard_ranges)

    def shard_of_row(self, row: int) -> int:
        for i, (lo, hi) in enumerate(self.shard_ranges):
            if lo <= int(row) < hi:
                return i
        return max(0, self.n_shards - 1)

    def app_states(self, shard: int) -> Dict[str, Any]:
        """Parse (once) and return one shard's {name: app_state}."""
        got = self._apps[shard]
        if got is None:
            raw = self._apps_raw[shard]
            got = json.loads(raw.decode("utf-8")) if raw else {}
            unmapped = self.meta.get("app_states_unmapped")
            if unmapped and shard == 0:
                got = {**unmapped, **got}
            self._apps[shard] = got
            self._apps_raw[shard] = None  # parsed: drop the raw bytes
        return got

    def all_app_states(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for i in range(self.n_shards):
            out.update(self.app_states(i))
        return out


def _open_manifest(
    directory: str, name: str
) -> Optional[CheckpointView]:
    """Build a view from one manifest, verifying every shard's content
    hash; None when the manifest or ANY shard is missing/torn/mismatched
    (the caller falls back to the previous generation)."""
    man = _manifest_at(directory, name)
    if man is None:
        return None
    gen = int(man.get("generation", _LEGACY))
    per_shard_arrays: List[Dict[str, np.ndarray]] = []
    ranges: List[Tuple[int, int]] = []
    apps_raw: List[Optional[bytes]] = []
    try:
        for ent in man["shards"]:
            path = os.path.join(directory, ent["file"])
            with open(path, "rb") as f:
                data = f.read()
            if hashlib.sha256(data).hexdigest() != ent["sha256"]:
                return None  # torn/corrupt shard write
            with np.load(io.BytesIO(data)) as z:
                if GEN_KEY not in z.files or int(z[GEN_KEY]) != gen:
                    return None
                lo, hi = (int(x) for x in z[ROWS_KEY])
                apps_raw.append(
                    z[APPS_KEY].tobytes() if APPS_KEY in z.files else None
                )
                per_shard_arrays.append({
                    k: z[k] for k in z.files
                    if k not in (GEN_KEY, ROWS_KEY, APPS_KEY)
                })
            ranges.append((lo, hi))
    except Exception:
        return None
    if not per_shard_arrays:
        return None
    arrays = {
        k: np.concatenate([s[k] for s in per_shard_arrays], axis=0)
        for k in per_shard_arrays[0]
    }
    meta = dict(man.get("meta") or {})
    meta.setdefault("generation", gen)
    meta.setdefault("journal_pos", man.get("journal_pos") or [0, 0])
    return CheckpointView(gen, arrays, meta, ranges, apps_raw)


def load_checkpoint_view(directory: str) -> Optional[CheckpointView]:
    """Newest loadable checkpoint in ANY format, as a lazy view.

    Candidates: the current sharded manifest, its prev fallback, and the
    legacy single-pair chain — the highest generation that fully
    verifies wins (a torn shard write disqualifies its whole
    generation, falling back to the previous anchor)."""
    view = _open_manifest(directory, MANIFEST)
    if view is None:
        view = _open_manifest(directory, PREV_MANIFEST)
    legacy = _load_checkpoint_legacy(directory)
    if legacy is not None:
        lgen, arrays, meta = legacy
        if view is None or lgen > view.generation:
            meta = dict(meta)
            apps = meta.pop("app_states", None) or {}
            G = 0
            for v in arrays.values():
                G = max(G, int(np.asarray(v).shape[0]))
            raw = json.dumps(apps, separators=(",", ":")).encode("utf-8")
            return CheckpointView(lgen, arrays, meta, [(0, G)], [raw])
    return view


def load_checkpoint(
    directory: str,
) -> Optional[Tuple[Dict[str, np.ndarray], Dict[str, Any]]]:
    """Eager (arrays, meta) load — meta includes ``app_states`` merged
    back in, whatever the on-disk format (legacy pair or shards)."""
    view = load_checkpoint_view(directory)
    if view is None:
        return None
    meta = dict(view.meta)
    meta.pop("app_states_unmapped", None)
    meta["app_states"] = view.all_app_states()
    return view.arrays, meta
