"""Stream-processing substrate: engine, operators, columnar and device state,
state backends and the workload generator."""

from .backends import (BACKENDS, ColumnarBackend, DeviceBackend,
                       StateBackend, register_backend)
from .device import DeviceStateFleet, DeviceTaskView
from .engine import STATE_BACKENDS, SUBSTRATES, IntervalReport, KeyedStage
from .generator import WorkloadGen, zipf_frequencies
from .operators import (IntervalBatchResult, MergeCounts, Operator,
                        WindowedSelfJoin, WordCount)
from .state import ColumnarPack, ColumnarSpec, ColumnarStateStore

__all__ = [
    "BACKENDS", "ColumnarBackend", "DeviceBackend", "StateBackend",
    "register_backend", "DeviceStateFleet", "DeviceTaskView",
    "STATE_BACKENDS", "SUBSTRATES", "IntervalReport", "KeyedStage",
    "WorkloadGen", "zipf_frequencies", "IntervalBatchResult", "MergeCounts",
    "Operator", "WindowedSelfJoin", "WordCount", "ColumnarPack",
    "ColumnarSpec", "ColumnarStateStore",
]
