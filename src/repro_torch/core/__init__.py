"""The paper's contribution: SLA-aware node-level batching (LazyBatching)."""
from .request import Request, SLAClass, SubBatch
from .batch_table import BatchTable
from .slack import SlackPredictor, OracleSlackPredictor
from .policies import (Policy, Serial, GraphBatching, CellularBatching,
                       LazyBatching, Oracle)
from .arbiter import (Arbiter, RoundRobinArbiter, LeastSlackArbiter,
                      ARBITERS)

__all__ = [
    "Request", "SLAClass", "SubBatch", "BatchTable", "SlackPredictor",
    "OracleSlackPredictor", "Policy", "Serial", "GraphBatching",
    "CellularBatching", "LazyBatching", "Oracle",
    "Arbiter", "RoundRobinArbiter", "LeastSlackArbiter", "ARBITERS",
]
