"""Interval-driven rebalance controller (paper Sec. IV, Fig. 5).

Protocol per interval (paper's numbered steps):
  1. workers report per-key stats (the stage's backend collects them, through
     the ``key_stats`` kernel on the ``"kernels"`` substrate, or streams them
     into the sketch through :meth:`RebalanceController.ingest`)
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
from .balancer.sketch import SketchConfig, SketchStats


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

    ``stats_mode`` selects how step-1 measurement reaches the planner:

    * ``"exact"`` (default) — callers hand over full per-key
      :class:`KeyStats`; O(K) per round, bit-exact.
    * ``"sketch"`` — callers stream batches through :meth:`ingest`
      (count-min sketch + SpaceSaving head tracker + exact per-dest
      totals, see :mod:`.balancer.sketch`) and close the round with
      ``on_interval(None)``; the planner then runs on a head-only snapshot
      whose ``base_loads`` freeze the tail on its hash destinations —
      O(H + sketch) memory and O(H) plan time regardless of the key
      domain. The trigger's theta stays exact (head estimate errors cancel
      against the derived base loads, up to clipping).
    """

    def __init__(self, assignment: Assignment, config: BalanceConfig,
                 algorithm="mixed",
                 executor: Optional[MigrationExecutor] = None,
                 stats_mode: str = "exact",
                 sketch: Optional[SketchConfig] = None):
        if stats_mode not in ("exact", "sketch"):
            raise ValueError(f"unknown stats_mode {stats_mode!r}; "
                             "choose 'exact' or 'sketch'")
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
        #: the stats the last protocol round planned on (exact or sketch
        #: snapshot) — what ``KeyedStage.last_stats``/``scale_to`` consume
        self.last_stats: Optional[KeyStats] = None
        self._sketch: Optional[SketchStats] = None
        if stats_mode == "sketch":
            cfg = sketch if sketch is not None else SketchConfig()
            seed = int(getattr(assignment.hash_router, "seed", 0))
            self._sketch = SketchStats(cfg, assignment.n_dest, seed=seed)
        elif sketch is not None:
            raise ValueError("sketch= config requires stats_mode='sketch'")

    @property
    def sketch(self) -> Optional[SketchStats]:
        """The live :class:`SketchStats` instance (sketch mode only)."""
        return self._sketch

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

    # -- paper step 1: array-native measurement handoff -----------------------
    def observe(self, keys: np.ndarray, cost: np.ndarray, mem: np.ndarray,
                freq: Optional[np.ndarray] = None,
                force: bool = False,
                interval: Optional[int] = None) -> ControllerEvent:
        """Ingest pre-aggregated per-key arrays and run one protocol round.

        Equivalent to ``on_interval(KeyStats(...), force)``; in sketch mode
        the arrays fold through :meth:`ingest` instead and the round plans
        on the head-only snapshot.
        """
        if self._sketch is not None:
            self.ingest(keys, cost, mem=mem, freq=freq)
            return self.on_interval(None, force=force, interval=interval)
        return self.on_interval(
            KeyStats(keys=keys, cost=cost, mem=mem, freq=freq), force=force,
            interval=interval)

    def ingest(self, keys: np.ndarray, cost: np.ndarray,
               mem: Optional[np.ndarray] = None,
               freq: Optional[np.ndarray] = None) -> None:
        """Sketch-mode streaming step-1 fold (any number of calls per
        interval; batches may repeat keys — everything accumulates).

        Destinations are resolved through the *current* assignment, which
        is constant within an interval (F only changes at interval
        boundaries), so the exact per-destination totals the trigger uses
        line up with where the tuples actually ran.
        """
        if self._sketch is None:
            raise ValueError("ingest() requires stats_mode='sketch'")
        keys = np.asarray(keys, dtype=np.int64)
        if not keys.size:
            return
        cost = np.asarray(cost, dtype=np.float64)
        # an all-zero-cost batch (the end-of-interval state-size fold)
        # contributes nothing per destination — skip the O(K) dest resolve
        dests = self.assignment.dest(keys) if cost.any() else None
        self._sketch.update(keys, dests, cost, mem=mem, freq=freq)

    # -- paper steps 2-7 ------------------------------------------------------
    def on_interval(self, stats: Optional[KeyStats], force: bool = False,
                    interval: Optional[int] = None) -> ControllerEvent:
        """One protocol round. ``interval`` pins the recorded event to the
        caller's interval clock (the stream engine passes its own counter);
        None keeps the self-incrementing counter.

        ``stats=None`` closes a sketch-mode interval: the round plans on the
        ingested data's head-only snapshot and the sketch resets for the
        next interval. Passing explicit stats works in either mode."""
        self._interval = self._interval + 1 if interval is None else interval
        if stats is None:
            if self._sketch is None:
                raise ValueError(
                    "on_interval(None) requires stats_mode='sketch'")
            stats = self._sketch.snapshot(self.assignment)
            self._sketch.end_interval()
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
