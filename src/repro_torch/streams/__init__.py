"""Stream-processing substrate: engine, operators, columnar and device state,
state backends, multi-stage topologies, checkpointed recovery and the
workload generator."""

from .backends import (BACKENDS, ColumnarBackend, DeviceBackend,
                       StateBackend, register_backend)
from .checkpoint import (CheckpointStore, StageCheckpoint, TopologyCheckpoint,
                         checkpoint_stage, checkpoint_topology, restore_stage,
                         restore_topology)
from .device import DeviceStateFleet, DeviceTaskView
from .engine import STATE_BACKENDS, SUBSTRATES, IntervalReport, KeyedStage
from .generator import WorkloadGen, zipf_frequencies
from .operators import (Filter, IntervalBatchResult, MergeCounts, Operator,
                        PartialWordCount, WindowedSelfJoin, WordCount)
from .state import ColumnarPack, ColumnarSpec, ColumnarStateStore
from .topology import (StageSpec, Topology, TopologyReport, keyed_stage,
                       router_merge_topology)

__all__ = [
    "BACKENDS", "ColumnarBackend", "DeviceBackend", "StateBackend",
    "register_backend", "DeviceStateFleet", "DeviceTaskView",
    "STATE_BACKENDS", "SUBSTRATES", "IntervalReport", "KeyedStage",
    "WorkloadGen", "zipf_frequencies", "Filter", "IntervalBatchResult",
    "MergeCounts", "Operator", "PartialWordCount", "WindowedSelfJoin",
    "WordCount", "ColumnarPack", "ColumnarSpec", "ColumnarStateStore",
    "StageSpec", "Topology", "TopologyReport", "keyed_stage",
    "router_merge_topology",
    "CheckpointStore", "StageCheckpoint", "TopologyCheckpoint",
    "checkpoint_stage", "checkpoint_topology", "restore_stage",
    "restore_topology",
]
