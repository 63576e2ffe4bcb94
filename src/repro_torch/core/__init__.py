"""Host control plane: the balancer and the interval rebalance controller."""

from .balancer import (Assignment, BalanceConfig, Hash32, KeyStats,
                       RebalanceResult)
from .controller import ControllerEvent, RebalanceController

__all__ = ["Assignment", "BalanceConfig", "Hash32", "KeyStats",
           "RebalanceResult", "ControllerEvent", "RebalanceController"]
