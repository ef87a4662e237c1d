"""Consistent hashing of service names onto reconfigurator/active rings.

API-parity target: ``reconfigurationutils/ConsistentHashing.java:40`` (MD5
ring with virtual nodes; ``getReplicatedServers`` walks the ring clockwise
from the name's hash).  Used for (a) which reconfigurator group owns a
name's RC record and (b) default initial placement of new names onto
actives.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Any, List, Sequence


def _md5_int(s: str) -> int:
    return int.from_bytes(hashlib.md5(s.encode("utf-8")).digest()[:8], "big")


class ConsistentHashing:
    """MD5 ring over a node set with virtual replication."""

    def __init__(self, nodes: Sequence[Any] = (), vnodes: int = 50):
        self.vnodes = vnodes
        self._ring: List[tuple] = []  # (hash, node) sorted
        self._nodes: List[Any] = []
        self.refresh(nodes)

    def refresh(self, nodes: Sequence[Any]) -> None:
        """Rebuild the ring for a new node set (elastic membership hook)."""
        self._nodes = sorted(set(nodes), key=str)
        ring = []
        for n in self._nodes:
            for v in range(self.vnodes):
                ring.append((_md5_int(f"{n}:{v}"), n))
        ring.sort(key=lambda t: (t[0], str(t[1])))
        self._ring = ring
        self._keys = [t[0] for t in ring]  # hash-only, for type-safe bisect

    @property
    def nodes(self) -> List[Any]:
        return list(self._nodes)

    def get_node(self, name: str) -> Any:
        """First ring node clockwise of the name's hash."""
        return self.get_replicated_servers(name, 1)[0]

    def get_replicated_servers(self, name: str, k: int = 3) -> List[Any]:
        """k distinct nodes clockwise from the name's hash
        (``getReplicatedServersArray`` analog)."""
        if not self._ring:
            raise ValueError("empty ring")
        k = min(k, len(self._nodes))
        h = _md5_int(name)
        i = bisect.bisect_left(self._keys, h)
        out: List[Any] = []
        n = len(self._ring)
        for off in range(n):
            node = self._ring[(i + off) % n][1]
            if node not in out:
                out.append(node)
                if len(out) == k:
                    break
        return out
