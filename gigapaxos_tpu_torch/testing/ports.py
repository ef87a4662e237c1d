"""Ephemeral-port reservation for loopback clusters.

A cluster's address book must be complete before any node starts, so the
transport's bind-port-0-and-read-back path can't be used — instead probe
N free ports up front (with the inherent small race; tests retry at a
higher level if a port is stolen between close and bind)."""

from __future__ import annotations

import socket
from typing import List

# reject probed ports this close to 65535: several listeners derive a
# SECOND port as base + offset (client-plane split at CLIENT_PORT_OFFSET,
# HTTP front ends), and an ephemeral base near the top of the OS range
# makes that derived bind overflow 65535
PORT_HEADROOM = 2048


def free_ports(n: int) -> List[int]:
    socks, ports = [], []
    tries = 0
    while len(ports) < n:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        if port > 65535 - PORT_HEADROOM:
            s.close()
            tries += 1
            if tries > 200:  # OS allocator stuck at the top of its range
                raise OSError("no ephemeral port with derived-port headroom")
            continue
        socks.append(s)
        ports.append(port)
    for s in socks:
        s.close()
    return ports
