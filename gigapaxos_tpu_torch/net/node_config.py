"""NodeConfig — the id -> (host, port) address book.

Ref: ``nio/interfaces/NodeConfig.java:29`` and the properties scheme
``active.NAME=host:port`` / ``reconfigurator.NAME=host:port``
(SURVEY.md §5, ``utils/Config``).  Node ids here are small ints (they
double as mesh/ballot coordinates); names map to ids in registration
order, mirroring the reference's string-node-id to int compression
(``paxosutil/IntegerMap.java:40``).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from ..utils.config import Config


class NodeConfig:
    def __init__(self, addresses: Optional[Dict[int, Tuple[str, int]]] = None):
        self._addr: Dict[int, Tuple[str, int]] = dict(addresses or {})
        self._names: Dict[int, str] = {}

    @classmethod
    def from_properties(cls, prefix: str = "active") -> "NodeConfig":
        """Build from ``{prefix}.NAME=host:port`` config entries; ids are
        assigned by sorted name order (deterministic across nodes)."""
        nc = cls()
        entries = Config.node_addresses(prefix)
        for i, name in enumerate(sorted(entries)):
            nc._addr[i] = entries[name]
            nc._names[i] = name
        return nc

    def add(self, node_id: int, host: str, port: int, name: str = "") -> None:
        self._addr[int(node_id)] = (host, int(port))
        if name:
            self._names[int(node_id)] = name

    def remove(self, node_id: int) -> None:
        self._addr.pop(int(node_id), None)
        self._names.pop(int(node_id), None)

    def get_node_address(self, node_id: int) -> Tuple[str, int]:
        return self._addr[int(node_id)]

    def get_node_ids(self) -> List[int]:
        return sorted(self._addr)

    def get_node_name(self, node_id: int) -> str:
        return self._names.get(int(node_id), str(node_id))

    def id_of_name(self, name: str) -> Optional[int]:
        for i, n in self._names.items():
            if n == name:
                return i
        return None

    def __contains__(self, node_id: int) -> bool:
        return int(node_id) in self._addr

    def __len__(self) -> int:
        return len(self._addr)
