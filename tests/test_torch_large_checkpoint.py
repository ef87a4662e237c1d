"""Large-checkpoint streaming on both packages:
``tests/test_large_checkpoint.py`` run on the JAX package and the port
(``device="cpu"``).

An 8 MB app state migrates from [AR0, AR1, AR2] to [AR1, AR2, AR3] as
paced chunk frames (``LargeCheckpointer.java:43``) while a side name keeps
answering.  Both packages must carry the count to the new replica set
(the first request of the new epoch counts on from it), answer the
same before the move, and keep the side name answering through the
stream.
"""

import threading
import time
from typing import Dict, Optional

from torch_pkgs import JAX, PKGS, TORCH

BIG = 8 * 1024 * 1024  # 8 MB app state


def _big_state_app(pkg):
    Replicable = pkg.mod("interfaces.app").Replicable
    RequestPacket = pkg.mod("packets.paxos_packets").RequestPacket

    class BigStateApp(Replicable):
        """A counter whose checkpoint pads to BIG bytes (the digits ride
        in front)."""

        def __init__(self):
            self.counts: Dict[str, int] = {}

        def execute(self, request, do_not_reply_to_client: bool = False) -> bool:
            name = request.get_service_name()
            self.counts[name] = self.counts.get(name, 0) + 1
            if hasattr(request, "response_value"):
                request.response_value = str(self.counts[name])
            return True

        def checkpoint(self, name: str) -> Optional[str]:
            head = f"{self.counts.get(name, 0)}:"
            return head + "x" * (BIG - len(head))

        def restore(self, name: str, state: Optional[str]) -> bool:
            if not state:
                self.counts.pop(name, None)
                return True
            self.counts[name] = int(state.split(":", 1)[0])
            return True

        def get_request(self, stringified: str):
            return RequestPacket(request_value=stringified)

    return BigStateApp


def _run(pkg):
    ports = pkg.mod("testing.ports").free_ports(8)
    Config = pkg.mod("utils.config").Config
    Config.clear()
    for i in range(4):
        Config.set(f"active.AR{i}", f"127.0.0.1:{ports[i]}")
    for i in range(3):
        Config.set(f"reconfigurator.RC{i}", f"127.0.0.1:{ports[4 + i]}")
    EngineConfig = pkg.mod("ops.engine").EngineConfig
    ar_cfg = EngineConfig(n_groups=32, window=8, req_lanes=4, n_replicas=4)
    rc_cfg = EngineConfig(n_groups=8, window=8, req_lanes=4, n_replicas=3)
    Node = pkg.mod("reconfigurable_node").ReconfigurableNode
    App = _big_state_app(pkg)
    nodes = [Node(f"AR{i}", App, ar_cfg=ar_cfg, rc_cfg=rc_cfg, **pkg.dev)
             for i in range(4)]
    nodes += [Node(f"RC{i}", App, ar_cfg=ar_cfg, rc_cfg=rc_cfg, **pkg.dev)
              for i in range(3)]
    for n in nodes:
        n.start()
    client = pkg.mod("clients.reconfigurable_client").ReconfigurableAppClient.from_properties()
    out = {}
    try:
        for nm in ("big", "side"):
            ack = client.create_name(nm, actives=[0, 1, 2], timeout=30)
            assert ack and ack.get("ok"), ack
        out["pre"] = [client.send_request_sync("big", "inc", timeout=15)
                      for _ in range(3)]
        out["warm"] = client.send_request_sync("side", "warm", timeout=15)

        side_lats = []
        stop_probe = threading.Event()

        def probe():
            while not stop_probe.is_set():
                t0 = time.time()
                if client.send_request_sync("side", "p", timeout=20) is not None:
                    side_lats.append(time.time() - t0)
                time.sleep(0.1)

        th = threading.Thread(target=probe, daemon=True)
        th.start()
        ack = client.reconfigure("big", [1, 2, 3], timeout=120)
        out["moved"] = bool(ack and ack.get("ok"))
        out["post"] = client.send_request_sync("big", "inc", timeout=30)
        stop_probe.set()
        th.join(timeout=5)
        out["side_lats"] = [round(x, 3) for x in side_lats]
        out["side_answered"] = bool(side_lats)
        out["side_max_under_5s"] = bool(side_lats) and max(side_lats) < 5.0
        m3 = nodes[3].servers[0].manager
        deadline = time.time() + 60
        while time.time() < deadline and m3.app.counts.get("big", 0) < 3:
            time.sleep(0.5)
        out["ar3_hosts"] = "big" in m3.names
        out["ar3_count_at_least_3"] = m3.app.counts.get("big", 0) >= 3
        return out
    finally:
        client.close()
        for n in nodes:
            n.stop()
        Config.clear()


def test_big_state_migration_streams_without_stalling():
    got = {pkg.root: _run(pkg) for pkg in PKGS}
    a, b = got[JAX.root], got[TORCH.root]
    assert a["pre"] == b["pre"] == ["1", "2", "3"]
    assert a["warm"] == b["warm"] == "1"
    for root, r in got.items():
        assert r["moved"], root
        assert r["side_answered"] and r["side_max_under_5s"], (
            f"{root}: side request latencies (s) {r['side_lats']}")
        assert r["post"] is not None and int(r["post"]) >= 4, root
        assert r["ar3_hosts"] and r["ar3_count_at_least_3"], root
