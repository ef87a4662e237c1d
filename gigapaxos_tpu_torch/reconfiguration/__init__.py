"""Reconfiguration layer: runtime create/delete of RSMs and replica-set
migration via epochs.

API-parity target: ``src/edu/umass/cs/reconfiguration`` — ``ActiveReplica``
(``ActiveReplica.java:128``), ``Reconfigurator`` (``Reconfigurator.java:125``),
``AbstractReplicaCoordinator`` (``AbstractReplicaCoordinator.java:100-117``),
``ReconfigurationRecord`` (``reconfigurationutils/ReconfigurationRecord.java:53-91``),
``ConsistentHashing`` (``reconfigurationutils/ConsistentHashing.java:40``) —
re-architected for the batched engine: a service name's replica group is a
row in the vectorized arrays; an epoch change stops the old row, hands its
final app state to the new epoch's row, and drops the old one.  The RC
records are themselves paxos-replicated on the same engine (a second
PaxosManager among the reconfigurators), mirroring the reference's
recursion (``RepliconfigurableReconfiguratorDB``).
"""

from .chash import ConsistentHashing
from .placement import (
    AbstractPlacementPolicy,
    MeasureOnlyPlacementPolicy,
    PlacementEngine,
    ProximateBalancePolicy,
)
from .record import RCState, ReconfigurationRecord

__all__ = [
    "AbstractPlacementPolicy",
    "ConsistentHashing",
    "MeasureOnlyPlacementPolicy",
    "PlacementEngine",
    "ProximateBalancePolicy",
    "RCState",
    "ReconfigurationRecord",
]
