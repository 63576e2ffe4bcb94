"""Autoscaling policy loop: observed interval load -> ``scale_to`` decisions.

The paper's protocol makes elasticity cheap *mechanically* (Fig. 15: state
migrates through the same Pause -> migrate -> Resume path as a rebalance),
but deciding *when* to scale is a policy question. This module closes that
loop with three deliberately separable pieces:

* :class:`AutoscalePolicy` — a watermark controller with hysteresis. Mean
  per-task load above ``high * target_load`` for ``patience`` consecutive
  intervals proposes scale-out; below ``low * target_load``, scale-in. The
  proposal is ``ceil(total_load / target_load)`` clipped to
  ``[min_tasks, max_tasks]`` — sized from demand, not incremented blindly.
* **The migration-cost damper** — before acting, the policy prices the
  proposal with the planner's own cost model: the keys that would move are
  exactly :func:`repro_torch.core.balancer.metrics.moved_keys` against the
  *interim* assignment (rehash to ``n'`` destinations, table entries to
  dead tasks dropped — the same first step ``RebalanceController.rescale``
  takes), and the predicted stall is their summed state bytes over the
  migration bandwidth. The action fires only when that stall pays back
  within ``payback_intervals`` of per-interval gain — the damper that keeps
  a borderline breach from thrashing the fleet.
* :class:`HeartbeatMonitor` — a stall detector over the same observability:
  a task reporting zero load for ``patience`` intervals while the stage
  moves traffic is flagged, feeding the failure path
  (:mod:`repro_torch.streams.faults`) rather than the scaling path.

:class:`AutoscaleLoop` wires policy + monitor onto one
:class:`~repro_torch.streams.engine.KeyedStage`, on any of its backends
(the device ring included: ``scale_to`` moves its state through the
ring's pack contract). Only table-planner strategies
can autoscale — choice routers reject ``scale_to`` by design (their
per-task load estimates cannot survive a fleet resize; see
``KeyedStage.scale_to``).

Hysteresis notes: the dead band between the watermarks, breach ``patience``,
post-action ``cooldown``, and the damper are each anti-oscillation devices;
``tests/test_torch_autoscale.py`` drives the drift and burst shapes and
holds the decision lists to the JAX package's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional

import numpy as np

from .balancer import Assignment, metrics

__all__ = ["AutoscaleConfig", "AutoscaleDecision", "AutoscalePolicy",
           "HeartbeatMonitor", "AutoscaleLoop"]


@dataclasses.dataclass
class AutoscaleConfig:
    """Watermark + damper knobs for :class:`AutoscalePolicy`.

    ``target_load`` is the per-task load (cost units per interval) the fleet
    is sized for; ``high``/``low`` are the watermark multipliers bracketing
    it (the gap is the hysteresis dead band). ``patience`` is how many
    consecutive breaching intervals arm an action; ``cooldown`` how many
    intervals after an action the policy stays quiet while migration
    settles. ``payback_intervals`` bounds the damper: act only when the
    predicted migration stall amortizes within that many intervals of gain.
    """

    target_load: float
    min_tasks: int = 1
    max_tasks: int = 64
    high: float = 1.25
    low: float = 0.6
    patience: int = 2
    cooldown: int = 2
    payback_intervals: float = 3.0

    def __post_init__(self):
        if self.target_load <= 0:
            raise ValueError(f"target_load must be > 0, got {self.target_load}")
        if not (1 <= self.min_tasks <= self.max_tasks):
            raise ValueError(
                f"need 1 <= min_tasks <= max_tasks, got "
                f"[{self.min_tasks}, {self.max_tasks}]")
        if not (0 < self.low < 1.0 <= self.high):
            raise ValueError(
                f"watermarks must satisfy 0 < low < 1 <= high, got "
                f"low={self.low}, high={self.high}")
        if self.patience < 1 or self.cooldown < 0:
            raise ValueError("patience must be >= 1 and cooldown >= 0")


@dataclasses.dataclass
class AutoscaleDecision:
    """One armed proposal — applied or vetoed by the migration damper."""

    interval: int
    from_tasks: int
    to_tasks: int
    reason: str                    # "scale-out" | "scale-in"
    predicted_bytes: float
    predicted_stall: float
    applied: bool


class AutoscalePolicy:
    """Stateful watermark controller; one ``observe`` call per interval."""

    def __init__(self, config: AutoscaleConfig):
        self.config = config
        self.decisions: List[AutoscaleDecision] = []
        self._breach_dir = 0           # +1 over high, -1 under low, 0 in band
        self._breach_run = 0
        self._cooldown = 0

    def desired_tasks(self, total_load: float) -> int:
        """Demand-sized fleet: ceil(total / target), clipped to the bounds."""
        c = self.config
        if total_load <= 0:
            return c.min_tasks
        return max(c.min_tasks,
                   min(c.max_tasks, math.ceil(total_load / c.target_load)))

    def predict_migration_bytes(self, stats, assignment: Assignment,
                                n_new: int) -> float:
        """State bytes a resize to ``n_new`` would move, per the planner's
        own model: rehash to ``n_new`` destinations with dead-task table
        entries dropped (the interim assignment ``rescale`` starts from),
        then sum ``S(k, w)`` over exactly ``metrics.moved_keys``."""
        if stats is None or stats.keys.size == 0:
            return 0.0
        interim = Assignment(
            assignment.hash_router.with_n_dest(n_new),
            {k: d for k, d in assignment.table.items() if d < n_new})
        moved = metrics.moved_keys(stats, assignment, interim)
        if moved.size == 0:
            return 0.0
        return float(stats.mem[np.isin(stats.keys, moved)].sum())

    def observe(self, report, stats, assignment: Assignment,
                migration_bandwidth: float) -> Optional[int]:
        """Feed one interval's observations; returns a new task count to
        apply, or None (in band / not yet armed / vetoed by the damper)."""
        c = self.config
        if self._cooldown > 0:
            self._cooldown -= 1
            self._breach_dir = 0
            self._breach_run = 0
            return None
        n = int(np.asarray(report.task_loads).shape[0])
        total = float(np.asarray(report.task_loads).sum())
        mean = total / n if n else 0.0
        if mean > c.high * c.target_load:
            direction = 1
        elif mean < c.low * c.target_load and n > c.min_tasks:
            direction = -1
        else:
            direction = 0
        if direction == 0:
            self._breach_dir = 0
            self._breach_run = 0
            return None
        if direction != self._breach_dir:
            self._breach_dir = direction
            self._breach_run = 0
        self._breach_run += 1
        if self._breach_run < c.patience:
            return None
        n_new = self.desired_tasks(total)
        if (direction > 0 and n_new <= n) or (direction < 0 and n_new >= n):
            # demand sizing disagrees with the breach (e.g. clipped at the
            # bounds, or one hot task skewing the mean): nothing to do
            self._breach_run = 0
            return None
        predicted = self.predict_migration_bytes(stats, assignment, n_new)
        stall = predicted / migration_bandwidth if migration_bandwidth else 0.0
        if direction > 0:
            # gain = critical-path reduction from spreading the same load
            gain = max(float(report.makespan) - total / n_new, 0.0)
        else:
            # gain = one task's worth of reclaimed capacity per interval
            gain = c.target_load
        applied = stall <= c.payback_intervals * gain
        self.decisions.append(AutoscaleDecision(
            interval=int(report.interval), from_tasks=n, to_tasks=n_new,
            reason="scale-out" if direction > 0 else "scale-in",
            predicted_bytes=predicted, predicted_stall=stall,
            applied=applied))
        self._breach_run = 0
        self._breach_dir = 0
        if not applied:
            return None                # damper veto: stall would not pay back
        self._cooldown = c.cooldown
        return n_new


class HeartbeatMonitor:
    """Flags tasks silent for ``patience`` intervals while traffic flows.

    "Silent" = zero observed load in an interval where the stage processed
    tuples — on an interval-synchronous engine the per-interval report IS
    the heartbeat, so a task that stops contributing shows up as a zero
    lane in ``task_loads``. Flags feed the failure path (restore + replay),
    not the scaling path: a dead task is a fault, not low demand.
    """

    def __init__(self, patience: int = 3):
        if patience < 1:
            raise ValueError(f"patience must be >= 1, got {patience}")
        self.patience = patience
        self.flagged: set = set()
        self._silent_runs: dict = {}

    def observe(self, report) -> List[int]:
        """Returns tasks *newly* flagged by this interval's heartbeat."""
        if int(report.tuples) == 0:
            return []                  # idle interval: no heartbeat expected
        loads = np.asarray(report.task_loads)
        newly: List[int] = []
        for task in range(loads.shape[0]):
            if loads[task] == 0:
                run = self._silent_runs.get(task, 0) + 1
                self._silent_runs[task] = run
                if run >= self.patience and task not in self.flagged:
                    self.flagged.add(task)
                    newly.append(task)
            else:
                self._silent_runs[task] = 0
                self.flagged.discard(task)
        return newly


class AutoscaleLoop:
    """Policy + monitor wired onto one stage: ``step`` per source interval."""

    def __init__(self, stage, config: AutoscaleConfig,
                 monitor: Optional[HeartbeatMonitor] = None):
        if stage.controller.strategy.is_router:
            raise ValueError(
                f"autoscaling requires a table-planner strategy; "
                f"{stage.controller.algorithm_name!r} is a choice router "
                "(scale_to rejects routers — their load estimates cannot "
                "survive a fleet resize)")
        self.stage = stage
        self.policy = AutoscalePolicy(config)
        self.monitor = monitor
        #: (interval, task) pairs the heartbeat monitor flagged as stalled
        self.stalled_tasks: List[Any] = []

    def step(self, keys: np.ndarray,
             values: Optional[np.ndarray] = None):
        """One interval: process, observe, maybe resize. Returns the report."""
        report = self.stage.process_interval_arrays(keys, values)
        if self.monitor is not None:
            for task in self.monitor.observe(report):
                self.stalled_tasks.append((int(report.interval), task))
        n_new = self.policy.observe(report, self.stage.last_stats,
                                    self.stage.controller.assignment,
                                    self.stage.migration_bandwidth)
        if n_new is not None and n_new != self.stage.n_tasks:
            self.stage.scale_to(n_new)
        return report

    @property
    def decisions(self) -> List[AutoscaleDecision]:
        return self.policy.decisions
