"""Segmented parallel journal replay.

The journal is already split at checkpoint-anchored boundaries: every
rotation is a block boundary, and the snapshot's ``journal_pos`` anchor
names the first (file, offset) to roll forward from.  Each file is one
*segment*: a scanner thread reads, CRC-verifies, and frames its blocks
(`storage.journal.read_file_blocks` — the native ``gp_journal.so`` CRC
releases the GIL during verification; ``GP_NO_NATIVE`` falls back to
zlib), while the consumer APPLIES blocks strictly in journal order, so
the vectorized rollforward semantics are byte-identical to a sequential
scan.  A segment ending in a torn/corrupt block invalidates everything
after it (single-writer append order), exactly like ``Journal.scan``.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Tuple

from ..storage.journal import (
    BlockType,
    Journal,
    _file_name,
    read_file_blocks,
)


def scan_segments(
    journal: Journal,
    from_file: int = 0,
    from_offset: int = 0,
    workers: int = 1,
) -> Iterator[Tuple[BlockType, bytes, int, Tuple[int, int]]]:
    """Yield journal blocks in order, scanning segments concurrently.

    Semantically identical to ``journal.scan(from_file, from_offset)``;
    with ``workers > 1`` and multiple files, the per-file read + CRC +
    framing runs on a thread pool while this generator drains results in
    file order.  Results from files past a torn segment are discarded —
    they are unreachable in a sequential scan too."""
    idxs = [i for i in journal.file_indices() if i >= from_file]
    if workers <= 1 or len(idxs) <= 1:
        yield from journal.scan(from_file, from_offset)
        return
    journal._fh.flush()
    workers = min(int(workers), len(idxs))
    with ThreadPoolExecutor(
        max_workers=workers, thread_name_prefix="gp-replay",
    ) as pool:
        # sliding submission window: scanners run at most `workers + 1`
        # files ahead of the in-order consumer, so peak memory is a few
        # decoded files — not the whole post-anchor journal (which at
        # the 256k-group shapes this plane targets can be GBs)
        from collections import deque

        pending: deque = deque()
        it = iter(idxs)

        def submit_next() -> bool:
            i = next(it, None)
            if i is None:
                return False
            pending.append((i, pool.submit(
                read_file_blocks,
                os.path.join(journal.dir, _file_name(i)),
                from_offset if i == from_file else 0,
            )))
            return True

        for _ in range(workers + 1):
            if not submit_next():
                break
        while pending:
            idx, fut = pending.popleft()
            blocks, clean = fut.result()
            submit_next()
            for btype, payload, n_rows, end in blocks:
                yield btype, payload, n_rows, (idx, end)
            blocks = None  # drained file: release before the next one
            if not clean:
                # blocks past a tear never existed to a sequential scan
                for _i, later in pending:
                    later.cancel()
                return
