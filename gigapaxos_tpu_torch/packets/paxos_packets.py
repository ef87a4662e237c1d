"""Paxos wire packets — dataclass forms with JSON and binary codecs.

Re-creation (not a port) of ``src/edu/umass/cs/gigapaxos/paxospackets/``
(SURVEY.md §2.2).  In this framework the inter-replica consensus traffic is
normally *tensors over ICI* (see ``ops/engine.py``), so these packet classes
serve (a) the client/entry path, (b) the journal/recovery record format,
(c) the host control plane (failure detection, sync, checkpoint transfer),
and (d) loopback/debug interop.

Binary layout: ``to_bytes`` frames each packet as a big-endian
``(type:int32, body_len:int32)`` header followed by the UTF-8 JSON body —
the general-purpose wire/debug form (the analog of the reference's
smart-JSON fallback).  The performance-critical paths do not use this
codec at all: inter-replica consensus traffic is packed int32 tensors
(``ops/engine.py``) and the durability journal uses its own fixed binary
record format (``storage/``), playing the role of the reference's
fixed-layout ``RequestPacket.toBytes`` (``RequestPacket.java:749-927``).
"""

from __future__ import annotations

import dataclasses
import json
import random
import struct
from dataclasses import dataclass, field
from typing import ClassVar, Dict, List, Optional, Tuple, Type

from .types import PaxosPacketType


# ---------------------------------------------------------------------------
# Ballot
# ---------------------------------------------------------------------------


@dataclass(frozen=True, order=True)
class Ballot:
    """A (ballot number, coordinator id) pair, lexicographically ordered.

    Ref: ``paxosutil/Ballot.java`` — two ints; the engine packs this into a
    single int32 as ``num << COORD_BITS | coord`` (see ``ops/ballot.py``).
    """

    num: int = -1
    coord: int = -1

    def __str__(self) -> str:
        return f"{self.num}:{self.coord}"

    @staticmethod
    def parse(s: str) -> "Ballot":
        num, _, coord = s.partition(":")
        return Ballot(int(num), int(coord))


# ---------------------------------------------------------------------------
# Base packet + registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[int, Type["PaxosPacket"]] = {}


@dataclass
class PaxosPacket:
    """Base: every packet carries (type, paxos_id, version).

    Ref: ``paxospackets/PaxosPacket.java:197-287``.
    """

    PACKET_TYPE: ClassVar[PaxosPacketType] = PaxosPacketType.NO_TYPE

    paxos_id: str = ""
    version: int = 0

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if "PACKET_TYPE" in cls.__dict__:
            _REGISTRY[int(cls.PACKET_TYPE)] = cls

    # ---- JSON codec ----------------------------------------------------
    def to_json(self) -> Dict:
        d = dataclasses.asdict(self)
        d["pt"] = int(self.PACKET_TYPE)
        return d

    def to_json_str(self) -> str:
        return json.dumps(self.to_json(), separators=(",", ":"))

    @classmethod
    def from_json(cls, d: Dict) -> "PaxosPacket":
        d = dict(d)
        d.pop("pt", None)
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in fields}
        obj = cls(**kwargs)
        return obj

    # ---- binary codec --------------------------------------------------
    def to_bytes(self) -> bytes:
        body = self.to_json_str().encode("utf-8")
        return struct.pack(">ii", int(self.PACKET_TYPE), len(body)) + body

    @staticmethod
    def from_bytes(data: bytes) -> "PaxosPacket":
        ptype, blen = struct.unpack_from(">ii", data, 0)
        body = data[8 : 8 + blen]
        cls = _REGISTRY.get(ptype, PaxosPacket)
        return cls.from_json(json.loads(body.decode("utf-8")))


def packet_from_json(d: Dict) -> PaxosPacket:
    cls = _REGISTRY.get(int(d.get("pt", 9999)), PaxosPacket)
    return cls.from_json(d)


# ---------------------------------------------------------------------------
# Client request
# ---------------------------------------------------------------------------


@dataclass
class RequestPacket(PaxosPacket):
    """A client request (ref: ``RequestPacket.java:55,83,189-246``).

    Carries a random 63-bit ``request_id``, the request value, a ``stop``
    flag (epoch-final), the entry-replica id and client address, and an
    optional nested batch of further requests coalesced by the batcher.
    """

    PACKET_TYPE: ClassVar[PaxosPacketType] = PaxosPacketType.REQUEST

    request_id: int = 0
    request_value: str = ""
    stop: bool = False
    entry_replica: int = -1
    client_address: Optional[Tuple[str, int]] = None
    response_value: Optional[str] = None
    batched: List["RequestPacket"] = field(default_factory=list)
    # engine-assigned fields
    entry_time: float = 0.0

    def __post_init__(self):
        if self.request_id == 0:
            self.request_id = random.randrange(1, 2 ** 62)
        # Nested entries may be subclasses (ProposalPacket/PValuePacket);
        # their "pt" tag picks the right class back out of the registry.
        self.batched = [
            (packet_from_json(b) if "pt" in b else RequestPacket.from_json(b))
            if isinstance(b, dict) else b
            for b in self.batched
        ]
        if isinstance(self.client_address, list):
            self.client_address = (self.client_address[0], self.client_address[1])

    def to_json(self) -> Dict:
        d = super().to_json()
        # asdict() deep-converts nested packets but drops their type tags;
        # re-emit each with its own to_json so round-trips preserve classes.
        d["batched"] = [b.to_json() for b in self.batched]
        return d

    # Request-ish API used by the manager/apps
    def get_service_name(self) -> str:
        return self.paxos_id

    def get_request_id(self) -> int:
        return self.request_id

    def is_stop(self) -> bool:
        return self.stop

    def batch_size(self) -> int:
        return 1 + len(self.batched)

    def flatten(self) -> List["RequestPacket"]:
        return [self] + list(self.batched)

    def latch_to_batch(self, others: List["RequestPacket"]) -> "RequestPacket":
        self.batched.extend(others)
        return self


@dataclass
class ProposalPacket(RequestPacket):
    """RequestPacket + slot (ref: ``ProposalPacket.java:36``)."""

    PACKET_TYPE: ClassVar[PaxosPacketType] = PaxosPacketType.PROPOSAL
    slot: int = -1


@dataclass
class PValuePacket(ProposalPacket):
    """Proposal + ballot: the unit of acceptance; doubles as DECISION and
    PREEMPTED (ref: ``PValuePacket.java:41``)."""

    PACKET_TYPE: ClassVar[PaxosPacketType] = PaxosPacketType.DECISION
    ballot_num: int = -1
    ballot_coord: int = -1
    median_checkpointed_slot: int = -1
    recovery: bool = False

    @property
    def ballot(self) -> Ballot:
        return Ballot(self.ballot_num, self.ballot_coord)


# ---------------------------------------------------------------------------
# Consensus phase packets (host/journal/debug form of the tensor lanes)
# ---------------------------------------------------------------------------


@dataclass
class PreparePacket(PaxosPacket):
    """Phase-1a (ref: ``PreparePacket.java``): ballot + firstUndecidedSlot."""

    PACKET_TYPE: ClassVar[PaxosPacketType] = PaxosPacketType.PREPARE
    ballot_num: int = -1
    ballot_coord: int = -1
    first_undecided_slot: int = 0


@dataclass
class PrepareReplyPacket(PaxosPacket):
    """Phase-1b (ref: ``PrepareReplyPacket.java``): promise + accepted map."""

    PACKET_TYPE: ClassVar[PaxosPacketType] = PaxosPacketType.PREPARE_REPLY
    acceptor: int = -1
    ballot_num: int = -1
    ballot_coord: int = -1
    # slot -> accepted pvalue (as json dicts when decoded from wire)
    accepted: Dict[int, PValuePacket] = field(default_factory=dict)
    first_slot: int = 0
    max_checkpointed_slot: int = -1

    def __post_init__(self):
        self.accepted = {
            int(k): (PValuePacket.from_json(v) if isinstance(v, dict) else v)
            for k, v in self.accepted.items()
        }


@dataclass
class AcceptPacket(PValuePacket):
    """Phase-2a (ref: ``AcceptPacket.java:37``): pvalue + sender."""

    PACKET_TYPE: ClassVar[PaxosPacketType] = PaxosPacketType.ACCEPT
    sender: int = -1


@dataclass
class AcceptReplyPacket(PaxosPacket):
    """Phase-2b (ref: ``AcceptReplyPacket.java``)."""

    PACKET_TYPE: ClassVar[PaxosPacketType] = PaxosPacketType.ACCEPT_REPLY
    acceptor: int = -1
    ballot_num: int = -1
    ballot_coord: int = -1
    slot: int = -1
    max_checkpointed_slot: int = -1


@dataclass
class BatchedCommit(PaxosPacket):
    """Coalesced commits per (paxos_id, ballot) (ref: ``BatchedCommit.java``)."""

    PACKET_TYPE: ClassVar[PaxosPacketType] = PaxosPacketType.BATCHED_COMMIT
    ballot_num: int = -1
    ballot_coord: int = -1
    slots: List[int] = field(default_factory=list)
    med_checkpointed_slot: int = -1


@dataclass
class StatePacket(PaxosPacket):
    """Checkpoint transfer (ref: ``StatePacket.java``) — the LIVE schema
    of the manager's straggler state_request/state_reply pulls
    (``PaxosManager._serve_state_request``): a donor's consistent
    (frontier == app cursor) snapshot of one group."""

    PACKET_TYPE: ClassVar[PaxosPacketType] = PaxosPacketType.CHECKPOINT_STATE
    ballot_num: int = -1
    ballot_coord: int = -1
    slot: int = -1           # donor's executed frontier
    state: Optional[str] = None  # app checkpoint string
    # TPU-build extras: row alignment + device-side RSM probes
    row: int = -1
    app_hash: int = 0
    n_execd: int = 0
    stopped: int = 0


@dataclass
class SyncDecisionsPacket(PaxosPacket):
    """Missing-slot catch-up request (ref: ``SyncDecisionsPacket.java``)."""

    PACKET_TYPE: ClassVar[PaxosPacketType] = PaxosPacketType.SYNC_DECISIONS
    node_id: int = -1
    max_decision_slot: int = -1
    missing: List[int] = field(default_factory=list)
    is_missing_too_much: bool = False


@dataclass
class FailureDetectionPacket(PaxosPacket):
    """Keep-alive ping (ref: ``FailureDetectionPacket.java``)."""

    PACKET_TYPE: ClassVar[PaxosPacketType] = PaxosPacketType.FAILURE_DETECT
    sender: str = ""
    responder: str = ""
    status: bool = True
    send_time: float = 0.0


@dataclass
class FindReplicaGroupPacket(PaxosPacket):
    """Group-membership discovery for missed births
    (ref: ``FindReplicaGroupPacket.java``)."""

    PACKET_TYPE: ClassVar[PaxosPacketType] = PaxosPacketType.FIND_REPLICA_GROUP
    node_id: int = -1
    group: List[int] = field(default_factory=list)
