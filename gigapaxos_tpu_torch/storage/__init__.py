"""Durability: append-only journal + engine-state snapshots + recovery.

The TPU-native replacement for the reference's ``SQLPaxosLogger``
(``gigapaxos/SQLPaxosLogger.java:123`` — embedded SQL tables for
checkpoint/pause plus append-only journal files): here ALL durable state
is array-shaped, so the journal holds packed int32 column blocks (bulk
``tobytes`` appends, CRC-framed) and a checkpoint is one ``.npz``
snapshot of the engine arrays — recovery is a bulk array load plus a
vectorized rollforward, not a per-group cursor walk.
"""

from .journal import BlockType, Journal
from .checkpoint import load_checkpoint, save_checkpoint
from .logger import PaxosLogger

__all__ = [
    "BlockType",
    "Journal",
    "PaxosLogger",
    "load_checkpoint",
    "save_checkpoint",
]
