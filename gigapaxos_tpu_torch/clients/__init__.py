"""Async clients (ref: ``gigapaxos/PaxosClientAsync.java:47`` and
``reconfiguration/ReconfigurableAppClientAsync.java:75``)."""

from .paxos_client import PaxosClientAsync

__all__ = ["PaxosClientAsync"]
