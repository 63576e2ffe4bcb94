"""Checkpointed recovery: interval-aligned stage/topology snapshots.

The recovery story rides entirely on seams that already exist:

* **State** travels as the same packs the migration path uses —
  :meth:`StateBackend.checkpoint` extracts every task's held keys through
  ``extract_batch``, clones the pack (``ObjectPack`` deepcopies its live
  ``KeyState`` refs; ``ColumnarPack`` rows are copied arrays) and installs
  it straight back, so a checkpoint is observationally transparent on every
  backend (object, columnar and device; the device backend also carries
  its ring-column clock).
* **Routing** travels as :meth:`RebalanceController.state_dict` —
  assignment table + hash router, ``assignment_version``, interval clock,
  trigger history, and (in sketch mode) the CMS/SpaceSaving contents via
  their own ``state_dict`` seams.
* **Time** is the interval boundary: a :class:`StageCheckpoint` is only
  meaningful *between* intervals, which is exactly when
  :class:`~repro_torch.streams.faults.ChaosRunner` takes them. Restoring
  rewinds the stage clock, so replaying the intervals after the checkpoint
  reproduces the original
  :class:`~repro_torch.streams.engine.IntervalReport` stream bit-for-bit
  (``tests/test_torch_topology.py``, ``tests/test_torch_faults.py``).

Durability uses the classic tmp-file + ``os.replace`` + manifest dance:
:class:`CheckpointStore` writes ``ckpt_<interval>.pkl`` atomically first,
then atomically replaces ``MANIFEST.json`` to point at it — a crash at any
point leaves the previous manifest (and therefore a complete, readable
checkpoint) in place.

This module imports neither the engine nor the topology: stages and
topologies are duck-typed, so it stays numpy and the standard library only.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = [
    "StageCheckpoint", "TopologyCheckpoint", "CheckpointStore",
    "checkpoint_stage", "restore_stage",
    "checkpoint_topology", "restore_topology",
]


@dataclasses.dataclass
class StageCheckpoint:
    """Everything needed to rebuild one KeyedStage at an interval boundary.

    ``packs`` holds one cloned state pack per task (the same pack types the
    migration path moves); ``backend_extra`` carries backend-private extras
    (the device fleet's ring-column clock ``col_iv`` — empty packs cannot
    carry it). ``pending_delta`` / ``migrated_bytes_pending`` /
    ``plan_time_pending`` are the cross-interval carry of the Pause ->
    migrate -> Resume protocol: a rebalance planned at interval *i* opens
    the pause window and books its stall during interval *i+1*, so a
    boundary-*i* checkpoint must preserve them for the replay to match.
    """

    backend: str                       # stage.state_backend, validated on restore
    interval: int
    n_tasks: int
    window: int
    packs: List[Any]                   # one cloned pack per task
    backend_extra: Dict[str, Any]
    pending_delta: Optional[np.ndarray]
    migrated_bytes_pending: float
    plan_time_pending: float
    table_capacity: int
    emitted_sum: float
    outputs: Dict[int, Any]
    reports: List[Any]
    last_stats: Any
    controller: Dict[str, Any]         # RebalanceController.state_dict()


def checkpoint_stage(stage) -> StageCheckpoint:
    """Snapshot ``stage`` at its current interval boundary.

    Must be called between intervals (never from inside
    ``process_interval``): the snapshot captures the post-interval-*i*
    boundary state, including any migration carry planned at *i*.
    """
    snap = stage.backend.checkpoint()
    packs = snap.pop("packs")
    return StageCheckpoint(
        backend=stage.state_backend,
        interval=stage._interval,
        n_tasks=stage.n_tasks,
        window=stage.window,
        packs=packs,
        backend_extra=snap,
        pending_delta=(stage._pending_delta_arr.copy()
                       if stage._pending_delta_arr is not None else None),
        migrated_bytes_pending=stage._migrated_bytes_pending,
        plan_time_pending=stage._plan_time_pending,
        table_capacity=stage._table_capacity,
        emitted_sum=stage.emitted_sum,
        outputs=dict(stage.outputs),
        reports=list(stage.reports),
        last_stats=stage.last_stats,
        controller=stage.controller.state_dict(),
    )


def restore_stage(stage, ckpt: StageCheckpoint) -> None:
    """Rebuild ``stage`` from ``ckpt`` (in place; reusable checkpoint).

    The target stage must be structurally compatible — same backend and
    window — but may be freshly constructed or mid-run with arbitrary state:
    everything run-dependent is overwritten. One checkpoint object restores
    any number of times (packs are re-cloned on install, the controller
    state is re-copied on load), which is what lets the chaos runner retry
    a replay that itself hits an injected fault.
    """
    if ckpt.backend != stage.state_backend:
        raise ValueError(
            f"checkpoint was taken on state_backend={ckpt.backend!r} but the "
            f"target stage runs {stage.state_backend!r}; packs are only "
            "portable within a backend")
    if ckpt.window != stage.window:
        raise ValueError(
            f"checkpoint window={ckpt.window} != stage window={stage.window}: "
            "the ring layout would not line up")
    stage.backend.restore(ckpt)
    stage.n_tasks = ckpt.n_tasks
    stage._interval = ckpt.interval
    # the per-tuple loop's membership set is rebuilt from the array on its
    # next interval; a set left from before the restore would be stale
    stage._pending_delta = None
    stage._pending_delta_arr = (ckpt.pending_delta.copy()
                                if ckpt.pending_delta is not None else None)
    stage._migrated_bytes_pending = float(ckpt.migrated_bytes_pending)
    stage._plan_time_pending = float(ckpt.plan_time_pending)
    stage._table_capacity = int(ckpt.table_capacity)
    # assignment_version rewinds on restore, so any cached routing keyed on
    # it would alias a *different* table — drop the caches unconditionally
    stage._route_cache = None
    stage.emitted_sum = float(ckpt.emitted_sum)
    stage.outputs = dict(ckpt.outputs)
    stage.reports = list(ckpt.reports)
    stage.last_stats = ckpt.last_stats
    stage.controller.load_state_dict(ckpt.controller)
    # the executor is a bound method of the (possibly new) stage, never
    # part of the serialized controller state — rewire it explicitly
    stage.controller.executor = stage._execute_migration


@dataclasses.dataclass
class TopologyCheckpoint:
    """A whole pipeline at one interval boundary: per-stage coordination.

    All stages snapshot at the *same* source interval — the topology clock —
    so a restore rewinds the entire chain coherently and replaying source
    traffic reproduces every stage's report stream.
    """

    interval: int
    last_emit_keys: np.ndarray
    last_emit_values: Any
    reports: List[Any]
    stages: List[StageCheckpoint]


def checkpoint_topology(topo) -> TopologyCheckpoint:
    """Snapshot every stage of ``topo`` at the current source boundary."""
    return TopologyCheckpoint(
        interval=topo._interval,
        last_emit_keys=np.asarray(topo.last_emit_keys).copy(),
        last_emit_values=(np.asarray(topo.last_emit_values).copy()
                          if topo.last_emit_values is not None else None),
        reports=list(topo.reports),
        stages=[checkpoint_stage(spec.stage) for spec in topo.specs],
    )


def restore_topology(topo, ckpt: TopologyCheckpoint) -> None:
    """Rebuild every stage of ``topo`` from a coherent pipeline snapshot."""
    if len(ckpt.stages) != len(topo.specs):
        raise ValueError(
            f"checkpoint has {len(ckpt.stages)} stages but the topology has "
            f"{len(topo.specs)}")
    for spec, stage_ckpt in zip(topo.specs, ckpt.stages):
        restore_stage(spec.stage, stage_ckpt)
    topo._interval = ckpt.interval
    topo.last_emit_keys = np.asarray(ckpt.last_emit_keys).copy()
    topo.last_emit_values = (np.asarray(ckpt.last_emit_values).copy()
                             if ckpt.last_emit_values is not None else None)
    topo.reports = list(ckpt.reports)


class CheckpointStore:
    """Durable checkpoint directory with an interval-aligned atomic manifest.

    Layout::

        <dir>/ckpt_00000004.pkl     one pickle per retained checkpoint
        <dir>/MANIFEST.json         {"latest": ..., "interval": ...}

    Both the checkpoint file and the manifest are written tmp-then-
    ``os.replace``, and the manifest is only flipped *after* the checkpoint
    file is fully on disk — a crash mid-save leaves the previous manifest
    pointing at a complete snapshot. ``keep`` bounds retention (older
    checkpoint files are unlinked after the manifest flip).
    """

    MANIFEST = "MANIFEST.json"

    def __init__(self, directory, keep: int = 2):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = str(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def save(self, ckpt) -> str:
        """Persist ``ckpt`` atomically and flip the manifest to it."""
        name = f"ckpt_{int(ckpt.interval):08d}.pkl"
        path = self._path(name)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(ckpt, f, protocol=pickle.HIGHEST_PROTOCOL)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        mtmp = self._path(self.MANIFEST + ".tmp")
        with open(mtmp, "w") as f:
            json.dump({"latest": name, "interval": int(ckpt.interval)}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(mtmp, self._path(self.MANIFEST))
        self._prune(keep_name=name)
        return path

    def _prune(self, keep_name: str) -> None:
        snaps = sorted(n for n in os.listdir(self.directory)
                       if n.startswith("ckpt_") and n.endswith(".pkl"))
        for stale in snaps[:-self.keep]:
            if stale != keep_name:
                os.unlink(self._path(stale))

    def latest_interval(self) -> Optional[int]:
        mpath = self._path(self.MANIFEST)
        if not os.path.exists(mpath):
            return None
        with open(mpath) as f:
            return int(json.load(f)["interval"])

    def load_latest(self):
        """The checkpoint the manifest points at, or None if none saved."""
        mpath = self._path(self.MANIFEST)
        if not os.path.exists(mpath):
            return None
        with open(mpath) as f:
            manifest = json.load(f)
        with open(self._path(manifest["latest"]), "rb") as f:
            return pickle.load(f)
