"""Host control plane: the balancer, the interval rebalance controller and
the autoscaling policy loop."""

from . import balancer
from .autoscale import (AutoscaleConfig, AutoscaleDecision, AutoscaleLoop,
                        AutoscalePolicy, HeartbeatMonitor)
from .balancer import (ALGORITHMS, Assignment, BalanceConfig, ConsistentHash, Hash32,
                       KeyStats, ModHash, PartialKeyGrouping,
                       PartitionStrategy, PowerOfBothChoices, RebalanceResult,
                       TablePlanner, WChoices, metrics, resolve_strategy,
                       strategy_names)
from .controller import ControllerEvent, RebalanceController

__all__ = ["balancer", "ALGORITHMS", "Assignment", "BalanceConfig", "ConsistentHash",
           "Hash32", "KeyStats", "ModHash", "RebalanceResult", "metrics",
           "ControllerEvent", "RebalanceController", "PartitionStrategy",
           "TablePlanner", "PartialKeyGrouping", "PowerOfBothChoices",
           "WChoices", "resolve_strategy", "strategy_names",
           "AutoscaleConfig", "AutoscaleDecision", "AutoscaleLoop",
           "AutoscalePolicy", "HeartbeatMonitor"]
