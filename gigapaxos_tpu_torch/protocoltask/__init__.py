"""Protocol-task runtime: keyed, restartable request/response state machines.

API-parity target: ``protocoltask/ProtocolExecutor.java:39`` (keyed task
store + scheduled restarts + event routing) and ``ThresholdProtocolTask.java``
(wait-for-acks-from-a-threshold with auto-retransmit to laggards) — the
substrate the reference's reconfiguration WaitAck* tasks are built on.
"""

from .executor import (
    MessagingTask,
    ProtocolExecutor,
    ProtocolTask,
    ThresholdProtocolTask,
)

__all__ = [
    "MessagingTask",
    "ProtocolExecutor",
    "ProtocolTask",
    "ThresholdProtocolTask",
]
