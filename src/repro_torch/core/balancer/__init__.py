"""Skew-shield balancer: the paper's Mixed planner (Alg. 4) on the host.

A numpy copy of the JAX package's control plane, trimmed to what the
interval protocol's main path runs: types, the Hash32 router, load metrics,
the LLFD workspace and Mixed, behind the strategy registry.
"""

from . import metrics
from .hashing import Hash32, fmix32
from .llfd import PlannerContext, Workspace
from .mixed import mixed
from .strategy import (PartitionStrategy, TablePlanner, register_planner,
                       register_strategy, resolve_strategy, strategy_names)
from .types import (Assignment, BalanceConfig, HashRouter, KeyStats,
                    RebalanceResult)

register_planner("mixed", mixed)

__all__ = [
    "Assignment", "BalanceConfig", "KeyStats", "RebalanceResult", "HashRouter",
    "Hash32", "fmix32", "metrics",
    "PlannerContext", "Workspace", "mixed",
    "PartitionStrategy", "TablePlanner", "register_planner",
    "register_strategy", "resolve_strategy", "strategy_names",
]
