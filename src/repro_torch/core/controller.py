"""Interval-driven rebalance controller (paper Sec. IV, Fig. 5).

Protocol per interval (paper's numbered steps):
  1. workers report per-key stats (the stage's backend collects them, through
     the ``key_stats`` kernel on the ``"kernels"`` substrate)
  2. controller evaluates imbalance; decides whether to trigger
  3. controller runs the algorithm (Mixed by default) -> F', Delta(F,F')
  4. Pause: only keys in Delta are affected
  5-6. state migration + acks (executor callback)
  7. Resume with the new assignment
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

from .balancer import (Assignment, BalanceConfig, KeyStats, RebalanceResult,
                       metrics, resolve_strategy)


@dataclasses.dataclass
class ControllerEvent:
    interval: int
    triggered: bool
    theta_before: float
    result: Optional[RebalanceResult] = None

    @property
    def theta_after(self) -> float:
        return self.result.theta if self.result else self.theta_before

    @property
    def migration_cost(self) -> float:
        return self.result.migration_cost if self.result else 0.0


MigrationExecutor = Callable[[np.ndarray, Assignment, Assignment], None]
"""(moved_keys, old_assignment, new_assignment) -> performs the state moves."""


class RebalanceController:
    """Owns the assignment function F and updates it at interval boundaries.

    ``stats_mode="exact"`` is the only mode: callers hand over full per-key
    :class:`KeyStats` each round. The count-min/SpaceSaving ``"sketch"``
    mode of the JAX package is not ported yet.
    """

    def __init__(self, assignment: Assignment, config: BalanceConfig,
                 algorithm="mixed",
                 executor: Optional[MigrationExecutor] = None,
                 stats_mode: str = "exact"):
        if stats_mode == "sketch":
            raise NotImplementedError(
                "stats_mode='sketch' is not ported yet: it lands with the "
                "slice that ports the count-min/SpaceSaving sketch")
        if stats_mode != "exact":
            raise ValueError(f"unknown stats_mode {stats_mode!r}; "
                             "choose 'exact'")
        self.stats_mode = stats_mode
        self.assignment = assignment
        self.config = config
        self.executor = executor
        self.use_algorithm(algorithm)
        self.history: List[ControllerEvent] = []
        self._interval = 0
        #: monotone counter bumped every time ``self.assignment`` is replaced
        #: (rebalance or rescale). Data planes key device-side routing-table
        #: caches on it so unchanged assignments skip the rebuild/re-upload.
        self.assignment_version = 0
        #: the stats the last protocol round planned on
        self.last_stats: Optional[KeyStats] = None

    def use_algorithm(self, algorithm) -> None:
        """Install an ``algorithm=`` spec: a registered strategy name, a bare
        planner callable ``(stats, assignment, config) -> RebalanceResult``,
        or a configured
        :class:`~repro_torch.core.balancer.strategy.PartitionStrategy`."""
        strategy = resolve_strategy(algorithm)
        if strategy.is_router:
            raise ValueError(
                f"algorithm {strategy.name!r} is a choice router; choice "
                "routers are not ported yet")
        strategy.bind(self.assignment)
        self.strategy = strategy
        self.algorithm_name = strategy.name

    # -- paper step 2: trigger decision --------------------------------------
    def should_trigger(self, stats: KeyStats) -> bool:
        return metrics.theta_for(stats, self.assignment) > self.config.theta_max

    def triggered_intervals(self) -> List[int]:
        """Intervals (1-based) where this controller actually rebalanced."""
        return [ev.interval for ev in self.history if ev.triggered]

    # -- paper steps 2-7 ------------------------------------------------------
    def on_interval(self, stats: KeyStats, force: bool = False,
                    interval: Optional[int] = None) -> ControllerEvent:
        """One protocol round. ``interval`` pins the recorded event to the
        caller's interval clock (the stream engine passes its own counter);
        None keeps the self-incrementing counter."""
        self._interval = self._interval + 1 if interval is None else interval
        self.last_stats = stats
        th = metrics.theta_for(stats, self.assignment)
        if not force and th <= self.config.theta_max:
            ev = ControllerEvent(self._interval, False, th)
            self.history.append(ev)
            return ev
        result = self.strategy.plan(stats, self.assignment, self.config)
        # Pause/migrate/Resume: the executor moves state for Delta(F,F') only
        if self.executor is not None and len(result.moved_keys):
            self.executor(result.moved_keys, self.assignment, result.assignment)
        self.assignment = result.assignment
        self.assignment_version += 1
        ev = ControllerEvent(self._interval, True, th, result)
        self.history.append(ev)
        return ev

    # -- elastic scale-out/in (paper Fig. 15) ---------------------------------
    def rescale(self, n_dest: int, stats: KeyStats) -> ControllerEvent:
        """Change the number of workers and rebalance onto the new fleet.

        Keys keep their table entries (still valid destinations if < n_dest);
        the hash router is swapped for the same family at the new size. The
        regular algorithm then restores balance with minimal migration.
        """
        old_assignment = self.assignment
        new_router = old_assignment.hash_router.with_n_dest(n_dest)
        table = {k: d for k, d in old_assignment.table.items() if d < n_dest}
        interim = Assignment(new_router, table)
        # keys that re-hash under the resized router migrate physically NOW —
        # the optimizer below only sees deltas relative to the interim mapping.
        if self.executor is not None:
            rehashed = metrics.moved_keys(stats, old_assignment, interim)
            if len(rehashed):
                self.executor(rehashed, old_assignment, interim)
        self.assignment = interim
        self.assignment_version += 1
        return self.on_interval(stats, force=True)
