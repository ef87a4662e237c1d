"""Host networking — the DCN/loopback transport (ref: ``nio/``, SURVEY §2.3).

This package carries client I/O, request payloads, control-plane
messages, and the blob exchange itself in loopback / multi-process
deployments (the analog of the reference's N-servers-on-127.0.0.1 mode).
"""

from .node_config import NodeConfig
from .transport import MessageTransport

__all__ = ["MessageTransport", "NodeConfig"]
