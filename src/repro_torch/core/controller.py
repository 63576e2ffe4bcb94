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

import copy
import dataclasses
from typing import Callable, List, Optional

import numpy as np

from .balancer import (Assignment, BalanceConfig, KeyStats, RebalanceResult,
                       metrics, resolve_strategy)
from .balancer.llfd import card_orders
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
        #: the CUDA device of the stage that owns this controller, which
        #: sets it: plans over large key universes order psi there
        #: (``balancer.llfd.card_orders``); None orders on the host
        self.plan_device = None
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
        :class:`~repro_torch.core.balancer.strategy.PartitionStrategy`
        (a table planner or a choice router)."""
        strategy = resolve_strategy(algorithm)
        strategy.bind(self.assignment)
        self.strategy = strategy
        self.algorithm_name = strategy.name

    # -- paper step 2: trigger decision --------------------------------------
    def should_trigger(self, stats: KeyStats) -> bool:
        if self.strategy.is_router:
            return False   # routers balance per tuple; nothing to (re)plan
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
        if self.strategy.is_router:
            # choice routers balance per tuple and never produce a plan: the
            # interval boundary is measurement only. theta reflects the
            # router's own routed-tuple loads; the head-set hook lets
            # W-Choices refresh its heavy hitters from the step-1 stats.
            self.strategy.on_stats(stats)
            loads = self.strategy.loads
            th = metrics.theta(loads) if loads.size else 0.0
            ev = ControllerEvent(self._interval, False, th)
            self.history.append(ev)
            return ev
        th = metrics.theta_for(stats, self.assignment)
        if not force and th <= self.config.theta_max:
            ev = ControllerEvent(self._interval, False, th)
            self.history.append(ev)
            return ev
        with card_orders(self.plan_device):
            result = self.strategy.plan(stats, self.assignment, self.config)
        # Pause/migrate/Resume: the executor moves state for Delta(F,F') only
        if self.executor is not None and len(result.moved_keys):
            self.executor(result.moved_keys, self.assignment, result.assignment)
        self.assignment = result.assignment
        self.assignment_version += 1
        ev = ControllerEvent(self._interval, True, th, result)
        self.history.append(ev)
        return ev

    # -- checkpoint seam (repro_torch.streams.checkpoint) ---------------------
    def state_dict(self) -> dict:
        """Everything a recovery needs to resume the protocol bit-identically:
        the assignment (routing table + hash), the version counter that keys
        device routing caches, the interval clock, the event history, the
        planned-on stats, the strategy (routers carry live per-tuple load
        state), and the sketch measurement state when in sketch mode.

        The returned dict owns its data (copies/deepcopies), so it stays
        valid however far the live controller advances afterwards, and it
        pickles for the on-disk manifest path.
        """
        return {
            "assignment": self.assignment.copy(),
            "assignment_version": self.assignment_version,
            "interval": self._interval,
            "history": list(self.history),
            "last_stats": self.last_stats,
            "strategy": copy.deepcopy(self.strategy),
            "stats_mode": self.stats_mode,
            "sketch": (self._sketch.state_dict()
                       if self._sketch is not None else None),
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore a :meth:`state_dict` snapshot. Deep-copies on the way in
        as well, so one checkpoint can be restored any number of times.

        The strategy is restored as-is, NOT re-``bind()``-ed: bind resets a
        choice router's load estimates, which are exactly the state the
        checkpoint preserves.
        """
        if state["stats_mode"] != self.stats_mode:
            raise ValueError(
                f"stats_mode mismatch: checkpoint was taken in "
                f"{state['stats_mode']!r} mode, controller runs "
                f"{self.stats_mode!r}")
        self.assignment = state["assignment"].copy()
        self.assignment_version = int(state["assignment_version"])
        self._interval = int(state["interval"])
        self.history = list(state["history"])
        self.last_stats = state["last_stats"]
        self.strategy = copy.deepcopy(state["strategy"])
        self.algorithm_name = self.strategy.name
        if state["sketch"] is not None:
            self._sketch.load_state_dict(state["sketch"])

    # -- elastic scale-out/in (paper Fig. 15) ---------------------------------
    def rescale(self, n_dest: int, stats: KeyStats) -> ControllerEvent:
        """Change the number of workers and rebalance onto the new fleet.

        Keys keep their table entries (still valid destinations if < n_dest);
        the hash router is swapped for the same family at the new size. The
        regular algorithm then restores balance with minimal migration.
        """
        if self.strategy.is_router:
            raise ValueError(
                f"algorithm {self.algorithm_name!r} is a choice router: "
                "per-key state is split across candidate workers, so the "
                "assignment-driven rescale/reconciliation protocol does not "
                "apply; rebuild the stage at the new width instead")
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

    # -- fleet health: straggler demotion (beyond the paper) ------------------
    def derate_worker(self, d: int, factor: float,
                      stats: KeyStats) -> ControllerEvent:
        """Treat worker ``d`` as ``factor``x slower (straggler): inflate the
        cost of its keys so the balancer migrates load away proportionally."""
        dests = self.assignment.dest(stats.keys)
        cost = stats.cost.copy()
        cost[dests == d] *= factor
        derated = KeyStats(keys=stats.keys, cost=cost, mem=stats.mem,
                           freq=stats.freq)
        return self.on_interval(derated, force=True)
