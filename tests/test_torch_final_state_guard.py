"""The epoch-final-state fallback refuses a truncated state, on both
packages: ``tests/test_final_state_guard.py`` run on the JAX package and
on the port (``device="cpu"``).

``_handle_request_final_state`` re-checkpoints a stopped group only when
the app cursor reached the device frontier.  The scenario runs once per
package on a scripted clock and one ``random`` seed; what each member served (kind, destination
and body, in order), the cursors, the app states and every engine leaf
are equal across the two, and the reference's own assertions hold on
each.
"""

import random

import numpy as np
import pytest

from torch_pkgs import JAX, TORCH, assert_leaves_equal, leaves, scripted


@pytest.fixture(autouse=True)
def _clear_torch_config():
    yield
    TORCH.mod("utils.config").Config.clear()


def fallback_refuses_truncated(pkg, clock):
    cfg = pkg.mod("ops.engine").EngineConfig(n_groups=4, window=8, req_lanes=4,
                                             n_replicas=3)
    c = pkg.mod("testing.cluster").ManagerCluster(
        cfg, pkg.mod("models.apps").HashChainApp, **pkg.dev)
    ActiveReplica = pkg.mod("reconfiguration.active_replica").ActiveReplica
    Coordinator = pkg.mod("reconfiguration.coordinator").PaxosReplicaCoordinator
    log = []

    def run(n):
        for _ in range(n):
            clock.t += 0.01
            c.step_all()

    try:
        c.create("svc", members=[0, 1, 2])
        sent = []
        ars = [ActiveReplica(r, Coordinator(c.managers[r].app, c.managers[r]),
                             (lambda dst, kind, body: sent.append((dst, kind, body))))
               for r in range(3)]
        # lag a NON-coordinator member: its device executes the decision
        # while its host app parks on the payload it never receives
        row0 = c.managers[0].names["svc"]
        coord = c.managers[0].coordinator_of_row(row0)
        lag = (coord + 1) % 3
        m1, ar1 = c.managers[lag], ars[lag]
        real_on_host = m1.on_host_message

        def drop_payloads(kind, body):
            if kind in ("payloads", "state_reply"):
                return  # the payload (and any state heal) never arrives
            real_on_host(kind, body)

        m1.on_host_message = drop_payloads
        c.submit("svc", "tail-request", entry=coord)
        run(10)
        # the epoch-final stop decides and device-executes everywhere
        c.submit("svc", "", entry=coord, stop=True, callback=None)
        run(10)
        row = m1.names["svc"]
        assert int(np.asarray(m1.state.stopped)[row]) == 1
        assert m1.is_stopped("svc")
        assert not m1.app_caught_up("svc")
        assert m1.app.n_executed.get("svc") is None
        log.append(("lagging", leaves(m1), dict(m1.app.state)))

        # a joiner asks the lagging member: the fallback stays SILENT
        ar1._handle_request_final_state({"name": "svc", "epoch": 0, "from": 2})
        assert not [m for m in sent if m[1] == "epoch_final_state"], sent

        # the coordinator executed everything: it serves the full history
        # and the dedup entries
        m0 = c.managers[coord]
        assert m0.app_caught_up("svc")
        ars[coord]._handle_request_final_state({"name": "svc", "epoch": 0, "from": 2})
        served = [m for m in sent if m[1] == "epoch_final_state"]
        assert served, "caught-up member must serve"
        body = served[0][2]
        assert body["state"] == m0.app.checkpoint("svc")
        assert body["dedup"], "dedup snapshot must ride along"
        log.append(("served", list(sent)))

        # once the payload lands, the lagging member catches up and serves
        # the SAME state
        m1.on_host_message = real_on_host
        run(30)
        caught = m1.app_caught_up("svc")
        log.append(("caught_up", caught))
        if caught:
            sent.clear()
            ar1._handle_request_final_state({"name": "svc", "epoch": 0, "from": 2})
            served2 = [m for m in sent if m[1] == "epoch_final_state"]
            assert served2 and served2[0][2]["state"] == body["state"]
            log.append(("served_after_catch_up", list(sent)))
        log.append(("end", [leaves(m) for m in c.managers],
                    [dict(m.app.state) for m in c.managers],
                    [dict(m.app.n_executed) for m in c.managers]))
    finally:
        c.close()
    return log


def test_fallback_refuses_truncated_final_state(monkeypatch):
    clock = scripted(monkeypatch)
    t0 = clock.t
    # request ids are minted from `random`: both runs draw the same ones
    random.seed(1234)
    ref = fallback_refuses_truncated(JAX, clock)
    clock.t = t0
    random.seed(1234)
    port = fallback_refuses_truncated(TORCH, clock)
    assert [e[0] for e in port] == [e[0] for e in ref]
    for a, b in zip(ref, port):
        if a[0] == "lagging":
            assert_leaves_equal(a[1], b[1], "lagging member")
            assert a[2] == b[2]
        elif a[0] == "end":
            for r, (x, y) in enumerate(zip(a[1], b[1])):
                assert_leaves_equal(x, y, f"member {r}")
            assert a[2:] == b[2:]
        else:
            assert a == b
