"""PyTorch port of the skew-shield stream processor for NVIDIA Hopper.

The paper's interval protocol (Fig. 5) end to end: routing F(k) (Eq. 1),
one interval's state update on a device-resident window ring, step-1
per-key statistics (exact, or a count-min/SpaceSaving sketch), the
controller's trigger and plan (Mixed, Alg. 4, by default, or any of the
paper's other table planners), and relabel-only migration. The two TPU kernels on that path — the routing
lookup and the per-key statistics histogram — are hand-written CUDA C++
(``csrc/``), each beside its plain PyTorch version.

The serving slice of the model substrate sits beside it: attention LMs
with dense or MoE MLPs (:mod:`.models`, :mod:`.configs`), SkewShield expert
placement (:mod:`.models.skewshield`), the serve step (:mod:`.train`), the
local serving launcher (:mod:`.launch.serve`) and the session-routing
serving engine (:mod:`.serve`), with the flash-attention TPU kernel
rewritten as CUDA C++ too.

This package imports torch, numpy and the standard library only; it keeps
its own copy of the host control plane and of the model code.
"""

from .core import (Assignment, BalanceConfig, Hash32, KeyStats,
                   RebalanceController)
from .streams import (KeyedStage, MergeCounts, WindowedSelfJoin, WordCount,
                      WorkloadGen)

__all__ = ["Assignment", "BalanceConfig", "Hash32", "KeyStats",
           "RebalanceController", "KeyedStage", "MergeCounts",
           "WindowedSelfJoin", "WordCount", "WorkloadGen"]
