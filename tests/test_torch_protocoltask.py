"""Protocol-task runtime on the port against the JAX package.

The JAX package's ``tests/test_protocoltask.py`` scenarios (keyed routing,
idempotent spawn, threshold acks with laggard-only retransmit, restarts,
expiry, direct send) run on both packages' ``protocoltask`` module with
the same scripted ``now``; each records what the executor emitted and what
it reported, and the two traces must be equal.  Each scenario then holds
the port's trace to the reference test's own assertions.
"""

import pytest

import gigapaxos_tpu.protocoltask as j_pt
import gigapaxos_tpu_torch.protocoltask as t_pt


def _tasks(pt):
    """The reference test's two task classes, over package ``pt``."""

    class PingTask(pt.ProtocolTask):
        restart_period_s = 1.0
        max_lifetime_s = 10.0

        def __init__(self, key, dsts):
            super().__init__(key)
            self.dsts = dsts
            self.expired = False

        def start(self):
            return [(d, "ping", {"key": self.key}) for d in self.dsts]

        def handle_event(self, kind, body):
            if kind == "pong":
                self.done = True
            return ()

        def on_expire(self):
            self.expired = True

    class MajorityAck(pt.ThresholdProtocolTask):
        restart_period_s = 1.0

        def __init__(self, key, nodes):
            super().__init__(key, nodes)
            self.fired = []

        def send_to(self, node):
            return (node, "req", {"key": self.key})

        def is_ack(self, kind, body):
            return body.get("from") if kind == "ack" else None

        def on_threshold(self):
            self.fired.append(tuple(sorted(self.acked)))
            return [("done-dst", "complete", {"key": self.key})]

    return PingTask, MajorityAck


def _spawn_routes_and_completes(pt):
    Ping, _ = _tasks(pt)
    ex = pt.ProtocolExecutor()
    tr = [ex.spawn(Ping("k1", [1, 2]), now=0.0), list(ex.outbox),
          ex.is_running("k1"), ex.handle_event("zzz", "pong", {}),
          ex.handle_event("k1", "pong", {}), ex.is_running("k1")]
    return tr


def _spawn_if_not_running(pt):
    Ping, _ = _tasks(pt)
    ex = pt.ProtocolExecutor()
    return [ex.spawn_if_not_running("k", lambda: Ping("k", [1]), now=0.0),
            ex.spawn_if_not_running("k", lambda: Ping("k", [1]), now=0.0),
            len(ex)]


def _threshold_laggard_retransmit(pt):
    _, Maj = _tasks(pt)
    ex = pt.ProtocolExecutor()
    t = Maj("m", [10, 11, 12])
    ex.spawn(t, now=0.0)
    tr = [list(ex.outbox)]
    ex.outbox.clear()
    ex.handle_event("m", "ack", {"from": 10})
    ex.tick(now=1.5)
    tr.append(sorted(m[0] for m in ex.outbox))
    ex.outbox.clear()
    ex.handle_event("m", "ack", {"from": 99})
    tr.append(t.done)
    ex.handle_event("m", "ack", {"from": 12})
    tr += [t.fired, list(ex.outbox), ex.is_running("m")]
    return tr


def _restart_period_and_expiry(pt):
    Ping, _ = _tasks(pt)
    ex = pt.ProtocolExecutor()
    t = Ping("p", [7])
    ex.spawn(t, now=0.0)
    ex.outbox.clear()
    tr = []
    for now in (0.5, 1.1, 11.0):
        ex.tick(now=now)
        tr.append(list(ex.outbox))
    tr += [t.expired, ex.is_running("p")]
    return tr


def _send_fn_direct_delivery(pt):
    Ping, _ = _tasks(pt)
    sent = []
    ex = pt.ProtocolExecutor(send=sent.append)
    ex.spawn(Ping("k", [3]), now=0.0)
    return [sent, ex.outbox]


def _task_store_cap(pt):
    Ping, _ = _tasks(pt)
    ex = pt.ProtocolExecutor()
    ex.MAX_TASKS = 2
    tr = [ex.spawn(Ping("a", [1]), now=0.0), ex.spawn(Ping("b", [1]), now=0.0)]
    with pytest.raises(RuntimeError):
        ex.spawn(Ping("c", [1]), now=0.0)
    tr += [ex.cancel("a"), ex.cancel("a"), len(ex)]
    return tr


SCENARIOS = {
    "spawn_routes_and_completes": (
        _spawn_routes_and_completes,
        [True, [(1, "ping", {"key": "k1"}), (2, "ping", {"key": "k1"})],
         True, False, True, False]),
    "spawn_if_not_running_idempotent": (_spawn_if_not_running, [True, False, 1]),
    "threshold_laggard_retransmit": (
        _threshold_laggard_retransmit,
        [[(10, "req", {"key": "m"}), (11, "req", {"key": "m"}), (12, "req", {"key": "m"})],
         [11, 12], False, [(10, 12)], [("done-dst", "complete", {"key": "m"})], False]),
    "restart_period_and_expiry": (
        _restart_period_and_expiry,
        [[], [(7, "ping", {"key": "p"})], [(7, "ping", {"key": "p"})], True, False]),
    "send_fn_direct_delivery": (_send_fn_direct_delivery, [[(3, "ping", {"key": "k"})], []]),
    "task_store_cap": (_task_store_cap, [True, True, True, False, 1]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_protocoltask_matches_jax(name):
    fn, want = SCENARIOS[name]
    got = fn(t_pt)
    assert got == fn(j_pt)
    assert got == want
