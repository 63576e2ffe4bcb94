"""PyTorch port of the skew-shield stream processor for NVIDIA Hopper.

The paper's interval protocol (Fig. 5) end to end: routing F(k) (Eq. 1),
one interval's state update on a device-resident window ring, step-1
per-key statistics, the controller's trigger and Mixed plan (Alg. 4), and
relabel-only migration. The two TPU kernels on that path — the routing
lookup and the per-key statistics histogram — are hand-written CUDA C++
(``csrc/``), each beside its plain PyTorch version.

This package imports torch, numpy and the standard library only; it keeps
its own copy of the host control plane.
"""

from .core import (Assignment, BalanceConfig, Hash32, KeyStats,
                   RebalanceController)
from .streams import (KeyedStage, MergeCounts, WindowedSelfJoin, WordCount,
                      WorkloadGen)

__all__ = ["Assignment", "BalanceConfig", "Hash32", "KeyStats",
           "RebalanceController", "KeyedStage", "MergeCounts",
           "WindowedSelfJoin", "WordCount", "WorkloadGen"]
