"""Example apps implementing the ``Replicable`` SPI.

* :class:`NoopPaxosApp` — echo app (ref: ``examples/noop/NoopPaxosApp.java``).
* :class:`StatefulAdderApp` — checkpointable counter
  (ref: ``examples/adder/StatefulAdderApp.java:1``).
* :class:`HashChainApp` — test fixture chaining a SHA-256 over every
  executed request so any ordering/duplication divergence changes the
  state hash (ref: ``testing/TESTPaxosApp.java:60,104,174``).
"""

from __future__ import annotations

import hashlib
from typing import Dict, Optional

from ..interfaces.app import Replicable, Request


class NoopPaxosApp(Replicable):
    """Stateless echo: every request 'executes' trivially."""

    def execute(self, request: Request, do_not_reply_to_client: bool = False) -> bool:
        if hasattr(request, "response_value"):
            request.response_value = "noop-ack"
        return True

    def checkpoint(self, name: str) -> Optional[str]:
        return ""

    def restore(self, name: str, state: Optional[str]) -> bool:
        return True

    def get_request(self, stringified: str) -> Request:
        from ..packets.paxos_packets import RequestPacket

        return RequestPacket(request_value=stringified)


class StatefulAdderApp(Replicable):
    """Per-name integer accumulator; request value is the delta."""

    def __init__(self):
        self.totals: Dict[str, int] = {}

    def execute(self, request: Request, do_not_reply_to_client: bool = False) -> bool:
        name = request.get_service_name()
        try:
            delta = int(getattr(request, "request_value", "0") or 0)
        except ValueError:
            delta = 0
        self.totals[name] = self.totals.get(name, 0) + delta
        if hasattr(request, "response_value"):
            request.response_value = str(self.totals[name])
        return True

    def checkpoint(self, name: str) -> Optional[str]:
        return str(self.totals.get(name, 0))

    def restore(self, name: str, state: Optional[str]) -> bool:
        if state is None or state == "":
            self.totals.pop(name, None)
        else:
            self.totals[name] = int(state)
        return True

    def get_request(self, stringified: str) -> Request:
        from ..packets.paxos_packets import RequestPacket

        return RequestPacket(request_value=stringified)


class LinWritesLocReadsApp(StatefulAdderApp):
    """Linearizable writes, local reads (ref:
    ``examples/linwrites/LinWritesLocReadsApp.java:23`` over
    ``SimpleAppRequest.java:32`` COORDINATED_WRITE/LOCAL_READ): delta
    values coordinate through consensus like the adder; the ``"read"``
    request executes UNCOORDINATED against this replica's local state —
    sequentially-consistent reads at zero consensus cost.  The
    coordinator consults :meth:`is_coordinated` to route."""

    READ = "read"

    def is_coordinated(self, value: str) -> bool:
        return value != self.READ

    def execute(self, request: Request, do_not_reply_to_client: bool = False) -> bool:
        if getattr(request, "request_value", "") == self.READ:
            name = request.get_service_name()
            if hasattr(request, "response_value"):
                request.response_value = str(self.totals.get(name, 0))
            return True
        return super().execute(request, do_not_reply_to_client)


class HashChainApp(Replicable):
    """SHA-chained state: state' = sha256(state || request_value)."""

    def __init__(self):
        self.state: Dict[str, str] = {}
        self.n_executed: Dict[str, int] = {}

    def execute(self, request: Request, do_not_reply_to_client: bool = False) -> bool:
        name = request.get_service_name()
        prev = self.state.get(name, "")
        val = getattr(request, "request_value", "")
        h = hashlib.sha256((prev + val).encode("utf-8")).hexdigest()
        self.state[name] = h
        self.n_executed[name] = self.n_executed.get(name, 0) + 1
        if hasattr(request, "response_value"):
            request.response_value = h[:16]
        return True

    def checkpoint(self, name: str) -> Optional[str]:
        import json

        return json.dumps(
            {"h": self.state.get(name, ""), "n": self.n_executed.get(name, 0)}
        )

    def restore(self, name: str, state: Optional[str]) -> bool:
        import json

        if not state:
            self.state.pop(name, None)
            self.n_executed.pop(name, None)
            return True
        d = json.loads(state)
        if not d["h"]:
            # an untouched chain's checkpoint: normalize to ABSENT so a
            # member that restored it and one that never touched the name
            # compare equal (the RSM checks compare state.get(name))
            self.state.pop(name, None)
            self.n_executed.pop(name, None)
            return True
        self.state[name] = d["h"]
        self.n_executed[name] = d["n"]
        return True

    def get_request(self, stringified: str) -> Request:
        from ..packets.paxos_packets import RequestPacket

        return RequestPacket(request_value=stringified)
