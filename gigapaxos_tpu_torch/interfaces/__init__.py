from .app import (
    Application,
    AppRequestParser,
    ClientRequest,
    ExecutedCallback,
    Replicable,
    Request,
    RequestIdentifier,
)

__all__ = [
    "Application",
    "AppRequestParser",
    "ClientRequest",
    "ExecutedCallback",
    "Replicable",
    "Request",
    "RequestIdentifier",
]
