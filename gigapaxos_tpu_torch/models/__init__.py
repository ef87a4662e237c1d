"""Example Replicable apps (ref: ``gigapaxos/examples/`` — NoopPaxosApp,
StatefulAdderApp) plus the hash-chain test fixture app."""

from .apps import HashChainApp, NoopPaxosApp, StatefulAdderApp

__all__ = ["HashChainApp", "NoopPaxosApp", "StatefulAdderApp"]
