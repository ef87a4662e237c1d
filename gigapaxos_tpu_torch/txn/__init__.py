from .app import (
    ABORTED,
    COMMITTED,
    TX_PREFIX,
    TXC_PREFIX,
    TXN_COORD,
    TxnApp,
    tx_op,
    txc_op,
)
from .driver import TxnDriver
from .recovery import TxnResolver
from .transactor import DistTransactor, Transaction, Transactor

__all__ = [
    "ABORTED",
    "COMMITTED",
    "TX_PREFIX",
    "TXC_PREFIX",
    "TXN_COORD",
    "DistTransactor",
    "Transaction",
    "Transactor",
    "TxnApp",
    "TxnDriver",
    "TxnResolver",
    "tx_op",
    "txc_op",
]
