"""Packet serialization on both packages: ``tests/test_packets.py`` run
on the JAX package and the port.

Each packet is built on both packages from the same fields; the JSON and
byte forms are equal, each package parses the other's, and the
round-trips keep every field (``RequestPacketTest.java``).  Request ids
are random where the caller gives none, so the two packets of a pair take
one id.
"""

import json

import pytest

from torch_pkgs import JAX, PKGS, TORCH


def _p(pkg):
    return pkg.mod("packets")


def _request(pkg, **kw):
    return _p(pkg).RequestPacket(request_id=kw.pop("request_id", 77), **kw)


def _same_json(a, b):
    assert json.loads(json.dumps(a.to_json())) == json.loads(json.dumps(b.to_json()))


def _cross_json(make):
    """Both packages' packets from ``make(pkg)``: equal JSON, and each
    package's parse of the other's JSON; returns {root: parsed}."""
    built = {pkg.root: make(pkg) for pkg in PKGS}
    _same_json(built[JAX.root], built[TORCH.root])
    return {
        pkg.root: _p(pkg).packet_from_json(built[other.root].to_json())
        for pkg, other in ((JAX, TORCH), (TORCH, JAX))
    }


def _cross_bytes(make):
    built = {pkg.root: make(pkg) for pkg in PKGS}
    assert built[JAX.root].to_bytes() == built[TORCH.root].to_bytes()
    return {
        pkg.root: _p(pkg).PaxosPacket.from_bytes(built[other.root].to_bytes())
        for pkg, other in ((JAX, TORCH), (TORCH, JAX))
    }


def test_request_roundtrip_json():
    backs = _cross_json(lambda pkg: _request(
        pkg, paxos_id="svc0", version=3, request_value="hello world", stop=True,
        entry_replica=1, client_address=("127.0.0.1", 9999)))
    for root, back in backs.items():
        assert type(back).__name__ == "RequestPacket", root
        assert back.paxos_id == "svc0" and back.version == 3
        assert back.request_value == "hello world"
        assert back.stop and back.entry_replica == 1
        assert back.client_address == ("127.0.0.1", 9999)
        assert back.request_id == 77


def test_request_roundtrip_bytes():
    backs = _cross_bytes(lambda pkg: _request(pkg, paxos_id="x",
                                              request_value="v" * 100))
    for back in backs.values():
        assert type(back).__name__ == "RequestPacket"
        assert back.request_value == "v" * 100


def test_batched_requests():
    def make(pkg):
        reqs = [_request(pkg, request_id=100 + i, paxos_id="s",
                         request_value=f"r{i}") for i in range(5)]
        return reqs[0].latch_to_batch(reqs[1:])

    for pkg, back in zip(PKGS, _cross_json(make).values()):
        again = _p(pkg).packet_from_json(back.to_json())
        assert again.batch_size() == 5
        assert [r.request_value for r in again.flatten()] == [f"r{i}" for i in range(5)]


def test_pvalue_and_accept():
    backs = _cross_bytes(lambda pkg: _p(pkg).AcceptPacket(
        paxos_id="g", slot=42, ballot_num=7, ballot_coord=2,
        request_value="payload", sender=0, request_id=5))
    for pkg, back in zip(PKGS, backs.values()):
        assert type(back).__name__ == "AcceptPacket"
        assert back.PACKET_TYPE == _p(pkg).PaxosPacketType.ACCEPT
        assert back.slot == 42 and back.ballot == _p(pkg).Ballot(7, 2)


def test_prepare_reply_accepted_map():
    def make(pkg):
        return _p(pkg).PrepareReplyPacket(
            paxos_id="g", acceptor=1, ballot_num=3, ballot_coord=0,
            accepted={5: _p(pkg).PValuePacket(
                paxos_id="g", slot=5, ballot_num=2, ballot_coord=1,
                request_value="v5", request_id=9)},
        )

    for back in _cross_json(make).values():
        assert type(back).__name__ == "PrepareReplyPacket"
        assert back.accepted[5].request_value == "v5"
        assert back.accepted[5].slot == 5


def test_prepare_and_fd():
    for back in _cross_json(lambda pkg: _p(pkg).PreparePacket(
            paxos_id="g", ballot_num=9, ballot_coord=1,
            first_undecided_slot=17)).values():
        assert back.first_undecided_slot == 17
    for back in _cross_json(lambda pkg: _p(pkg).FailureDetectionPacket(
            sender="AR0", responder="AR1", send_time=1.25)).values():
        assert back.sender == "AR0" and back.send_time == 1.25


@pytest.mark.parametrize("a,b", [((2, 1), (1, 9)), ((2, 3), (2, 1)),
                                 ((5, 2), (5, 2))])
def test_ballot_ordering(a, b):
    got = []
    for pkg in PKGS:
        B = _p(pkg).Ballot
        got.append((B(*a) > B(*b), B(*a) == B(*b), B.parse(f"{a[0]}:{a[1]}") == B(*a),
                    str(B(*a))))
    assert got[0] == got[1]
    assert got[0][0] or got[0][1]
