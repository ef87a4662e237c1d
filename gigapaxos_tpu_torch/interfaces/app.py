"""Application SPI — the ``Replicable`` contract apps implement.

Re-creation of the reference's app-facing interfaces
(``src/edu/umass/cs/gigapaxos/interfaces/`` — ``Replicable.java:21``,
``Request``, ``ClientRequest`` (carries a response), ``RequestIdentifier``,
``ExecutedCallback``, ``AppRequestParser``), with the same names and
semantics so example apps and the reconfiguration layer sit on an unchanged
SPI while the consensus engine underneath is the batched TPU core.

Semantics preserved from the reference:
  * ``execute`` must be deterministic across replicas and is retried forever
    by the engine on False/exception (``PaxosInstanceStateMachine.java:1647-1734``).
  * ``checkpoint(name)`` returns a string capturing the full app state for
    ``name``; ``restore(name, state)`` must accept ``None`` to mean "reset
    to initial/blank state" (``Replicable.java:70-105``).
  * ``ClientRequest.get_response()`` supplies the value sent back to the
    requesting client by the entry replica only.
"""

from __future__ import annotations

import abc
from typing import Callable, Iterable, Optional


class Request(abc.ABC):
    """A request (usually also a RequestIdentifier) targeting a service name."""

    @abc.abstractmethod
    def get_service_name(self) -> str: ...

    @abc.abstractmethod
    def get_request_type(self) -> int: ...

    def is_stop(self) -> bool:
        """True for epoch-final 'stop' requests (ref: RequestPacket.stop)."""
        return False


class RequestIdentifier(abc.ABC):
    @abc.abstractmethod
    def get_request_id(self) -> int: ...


class ClientRequest(Request, RequestIdentifier):
    """A request originated by a client, able to carry back a response."""

    def get_response(self) -> Optional["ClientRequest"]:
        return None


# Callback invoked when a request has been executed by the local replica.
# Signature: callback(request, handled: bool) -> None
ExecutedCallback = Callable[[Request, bool], None]


class AppRequestParser(abc.ABC):
    """Parse wire strings into app request objects (ref: AppRequestParser)."""

    @abc.abstractmethod
    def get_request(self, stringified: str) -> Request: ...

    def get_request_types(self) -> Iterable[int]:
        return ()


class Application(AppRequestParser):
    """An app executing requests (ref: Application.java)."""

    @abc.abstractmethod
    def execute(self, request: Request, do_not_reply_to_client: bool = False) -> bool: ...


class Replicable(Application):
    """An app that can be replicated: adds checkpoint/restore.

    Ref: ``gigapaxos/interfaces/Replicable.java:21``.
    """

    @abc.abstractmethod
    def checkpoint(self, name: str) -> Optional[str]: ...

    @abc.abstractmethod
    def restore(self, name: str, state: Optional[str]) -> bool: ...
