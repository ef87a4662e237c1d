"""Recovery plane — bounded restart-to-serving.

Three cooperating pieces turn restart from "replay everything, then
serve" into "serve hot names within a bounded window, hydrate the cold
tail in the background":

* sharded checkpoints with a hashed manifest
  (:mod:`gigapaxos_tpu_torch.storage.checkpoint`) — torn shard writes are
  detected by content hash and recovery falls back to the previous
  generation's journal anchor;
* segmented parallel replay (:mod:`.replay`) — journal files after the
  anchor scan/CRC-verify/decode concurrently, blocks apply in order;
* lazy per-name hydration (:mod:`.hydration`) — the engine arrays load
  in bulk, hot names (recency-ordered from the manifest hints) restore
  synchronously, and the cold tail's app states hydrate in a background
  worker, with requests for a cold name triggering priority hydration.
"""

from .hydration import Hydrator
from .replay import scan_segments

__all__ = ["Hydrator", "scan_segments"]
