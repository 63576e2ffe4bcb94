"""PyTorch port of the skew-shield stream processor for NVIDIA Hopper.

The paper's interval protocol (Fig. 5) end to end: routing F(k) (Eq. 1),
one interval's state update on a device-resident window ring, step-1
per-key statistics (exact, or a count-min/SpaceSaving sketch), the
controller's trigger and plan (Mixed, Alg. 4, by default, or any of the
paper's other table planners), and relabel-only migration. The two TPU
kernels on that path — the routing lookup and the per-key statistics
histogram — are hand-written CUDA C++ (``csrc/``), each beside its plain
PyTorch version. Around it: the competing choice routers (PKG, the Power of
Both Choices, W-Choices) on the host, multi-stage topologies (a router's
split stage feeding a merge stage) and checkpointed recovery.

The model substrate sits beside it: attention LMs with dense or MoE MLPs
(:mod:`.models`, :mod:`.configs`), SkewShield expert placement
(:mod:`.models.skewshield`), the serve and train steps, AdamW, checkpoints
and the trainer (:mod:`.train`), the keyed data pipeline (:mod:`.data`),
the local serving and training launchers (:mod:`.launch`) and the
session-routing serving engine (:mod:`.serve`), with the flash-attention
TPU kernel rewritten as CUDA C++ too.

This package imports torch, numpy and the standard library only; it keeps
its own copy of the host control plane and of the model code.
"""

from .core import (Assignment, BalanceConfig, ConsistentHash, Hash32,
                   KeyStats, ModHash, RebalanceController, resolve_strategy,
                   strategy_names)
from .data import KeyedDataPipeline, zipf_sources
from .streams import (Filter, KeyedStage, MergeCounts, PartialWordCount,
                      StageSpec, Topology, WindowedSelfJoin, WordCount,
                      WorkloadGen, keyed_stage, router_merge_topology)
from .train import OptConfig, Trainer, TrainerConfig

__all__ = ["Assignment", "BalanceConfig", "ConsistentHash", "Hash32",
           "KeyStats", "ModHash", "RebalanceController", "resolve_strategy",
           "strategy_names", "Filter", "KeyedStage", "MergeCounts",
           "PartialWordCount", "StageSpec", "Topology", "WindowedSelfJoin",
           "WordCount", "WorkloadGen", "keyed_stage",
           "router_merge_topology", "KeyedDataPipeline", "zipf_sources",
           "OptConfig", "Trainer", "TrainerConfig"]
