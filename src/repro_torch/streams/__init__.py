"""Stream-processing substrate: engine, operators, object, columnar and
device state, state backends (the sharded one loaded on first use), multi-stage topologies, checkpointed recovery
with deterministic failure injection, and the workload generator."""

from .backends import (BACKENDS, ColumnarBackend, DeviceBackend,
                       ObjectBackend, StateBackend, register_backend)
from .checkpoint import (CheckpointStore, StageCheckpoint, TopologyCheckpoint,
                         checkpoint_stage, checkpoint_topology, restore_stage,
                         restore_topology)
from .device import DeviceStateFleet, DeviceTaskView
from .engine import STATE_BACKENDS, SUBSTRATES, IntervalReport, KeyedStage
from .faults import (ChaosRunner, DropDelivery, DuplicateDelivery, FaultPlan,
                     FaultInjector, KillTask, RecoveryEvent, StallTask,
                     TaskKilled, TaskStalled)
from .generator import WorkloadGen, zipf_frequencies
from .operators import (BatchResult, Filter, IntervalBatchResult, MergeCounts,
                        Operator, PartialWordCount, WindowedSelfJoin,
                        WordCount)
from .state import (ColumnarPack, ColumnarSpec, ColumnarStateStore, KeyState,
                    ObjectPack, TaskStateStore, WindowSlice)
from .topology import (StageSpec, Topology, TopologyReport, keyed_stage,
                       router_merge_topology)

__all__ = [
    "BACKENDS", "ColumnarBackend", "DeviceBackend", "ObjectBackend",
    "StateBackend", "register_backend", "DeviceStateFleet", "DeviceTaskView",
    "STATE_BACKENDS", "SUBSTRATES", "IntervalReport", "KeyedStage",
    "WorkloadGen", "zipf_frequencies", "BatchResult", "Filter",
    "IntervalBatchResult", "MergeCounts", "Operator", "PartialWordCount",
    "WindowedSelfJoin", "WordCount", "ColumnarPack", "ColumnarSpec",
    "ColumnarStateStore", "KeyState", "ObjectPack", "TaskStateStore",
    "WindowSlice",
    "StageSpec", "Topology", "TopologyReport", "keyed_stage",
    "router_merge_topology",
    "CheckpointStore", "StageCheckpoint", "TopologyCheckpoint",
    "checkpoint_stage", "checkpoint_topology", "restore_stage",
    "restore_topology",
    "ChaosRunner", "DropDelivery", "DuplicateDelivery", "FaultPlan",
    "FaultInjector", "KillTask", "RecoveryEvent", "StallTask",
    "TaskKilled", "TaskStalled",
    "ShardedDeviceBackend", "ShardedStateFleet",
]


def __getattr__(name):
    # the sharded backend loads torch.distributed: imported on first use
    if name in ("ShardedDeviceBackend", "ShardedStateFleet"):
        from . import sharded
        return getattr(sharded, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
