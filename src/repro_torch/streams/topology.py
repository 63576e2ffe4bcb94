"""Multi-stage streaming topologies: chained keyed operators (paper Fig. 5,
run per logical operator).

A real stream job is a chain ``O_1 -> O_2 -> ...`` where every operator is
key-partitioned over its own task fleet and tuples are *re-keyed* between
operators — the paper's protocol runs independently at each operator.
:class:`Topology` models that:

* each :class:`StageSpec` wraps a full
  :class:`~repro_torch.streams.engine.KeyedStage` — its own
  :class:`~repro_torch.core.controller.RebalanceController`, its own
  ``Assignment`` (routing table + hash), its own store fleet;
* stage *i*'s batched emit stream
  (:meth:`~repro_torch.streams.engine.KeyedStage.process_interval_emits`,
  built on the operators' closed forms) is re-keyed by the next spec's
  vectorized ``rekey`` into stage *i+1*'s batch — arrays end to end, so
  the device ring and the kernels serve every stage that can take them;
* rebalances at different stages may fire within the *same* interval, each
  pausing only its own Delta keys and replaying them on Resume.

:func:`router_merge_topology` is the choice routers' deployment: a
split-safe partial operator under a router, then a merge stage under a
table planner. On a card, ``state_backend="auto"`` puts the split stage on
the columnar store (the device backend refuses routers) and a merge stage
whose operator has device closed forms on the device ring.

Performance model
-----------------
A tuple admitted in interval ``T_i`` must clear every stage within the
interval, so the pipeline's critical path is the *sum* of per-stage critical
paths (each already ``max task cost + migration stall``):

    makespan_pipeline = sum_i (makespan_i + stall_i)
    throughput        = source tuples / makespan_pipeline

(relative units, the same shape of quantity the paper measures on Storm).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..core import Assignment, BalanceConfig, ModHash, RebalanceController

from .engine import IntervalReport, KeyedStage
from .operators import Operator

#: Vectorized edge re-keying: maps the upstream emit stream's (keys, values)
#: arrays to this stage's routing keys. ``values`` may be None for stage 0.
Rekey = Callable[[np.ndarray, Optional[np.ndarray]], np.ndarray]


@dataclasses.dataclass
class StageSpec:
    """One pipeline stage: a named KeyedStage plus its inbound re-keying.

    ``rekey`` (optional) maps incoming ``(keys, values)`` to the routing
    keys this stage partitions on — e.g. orderkey -> custkey ahead of a
    join, or word -> bucket ahead of a top-k front. ``None`` routes on the
    incoming keys unchanged. It must be a deterministic vectorized function
    so both engine paths (and repeated runs) derive the same partitioning.
    """

    name: str
    stage: KeyedStage
    rekey: Optional[Rekey] = None


@dataclasses.dataclass
class TopologyReport:
    """Per-interval pipeline roll-up over the per-stage IntervalReports."""

    interval: int
    tuples_in: int                        # source tuples admitted
    stage_tuples: List[int]               # input size per stage (post-filter)
    stage_reports: List[IntervalReport]
    critical_path: float                  # sum_i (makespan_i + stall_i)
    throughput: float                     # tuples_in / critical_path
    migrated_bytes: float                 # summed over stages
    buffered: int                         # tuples paused, summed over stages


def keyed_stage(operator: Operator, n_tasks: int, theta_max: float, *,
                table_max: int = 2_000, window: int = 2, seed: int = 0,
                algorithm="mixed", hash_cls=ModHash, vectorized: bool = True,
                substrate: str = "numpy", state_backend: str = "auto",
                n_shards: Optional[int] = None,
                device=None, migration_bandwidth: float = 1e6,
                stats_mode: str = "exact",
                sketch=None) -> KeyedStage:
    """Convenience constructor: one stage = operator + fresh controller fleet.

    Every call builds an independent ``Assignment``/``RebalanceController``
    pair, which is what per-stage rebalance requires — stages must never
    share a controller (their tables, Delta sets and trigger decisions are
    per-operator state, exactly as in the paper's per-operator protocol).
    ``vectorized``/``substrate``/``state_backend``/``n_shards``/``device``
    pass straight through to :class:`~repro_torch.streams.engine.KeyedStage`; the kernels
    and the device ring need ``hash_cls=Hash32`` (the default ``ModHash``
    is host only, as in the JAX package).

    ``algorithm`` takes the unified strategy spec — a registered name from
    :func:`repro_torch.core.balancer.strategy_names` (table planners like
    ``"mixed"``/``"mintable"``/``"minmig"``/``"readj"`` *or* choice routers
    ``"pkg"``/``"potc"``/``"wchoices"``), a bare planner callable, or a
    configured :class:`~repro_torch.core.balancer.PartitionStrategy`
    instance. Router strategies split keys across tasks, so the operator
    must be ``split_safe`` (see :func:`router_merge_topology`).

    ``stats_mode``/``sketch`` pass straight through to
    :class:`~repro_torch.core.controller.RebalanceController`.

    The JAX package's ``kernel_interpret`` is not taken: interpret mode is
    Pallas's (the port's wrappers run their plain versions on CPU tensors
    instead).
    """
    controller = RebalanceController(
        Assignment(hash_cls(n_tasks, seed=seed)),
        BalanceConfig(theta_max=theta_max, table_max=table_max,
                      window=window),
        algorithm=algorithm,
        stats_mode=stats_mode, sketch=sketch)
    return KeyedStage(operator, controller, window=window,
                      vectorized=vectorized, substrate=substrate,
                      state_backend=state_backend, n_shards=n_shards,
                      device=device, migration_bandwidth=migration_bandwidth)


def router_merge_topology(partial_op: Operator, merge_op: Operator,
                          n_tasks: int, theta_max: float, *,
                          algorithm="pkg", merge_tasks: Optional[int] = None,
                          merge_algorithm="mixed", seed: int = 0,
                          **stage_kwargs) -> "Topology":
    """The canonical choice-router pairing: split stage + downstream merge.

    Choice routers (``"pkg"``/``"potc"``/``"wchoices"``) split one key's
    tuples across candidate tasks, which is exactly the PKG papers' two-step
    dataflow (Fig. 2a of 1510.07623): a *split-safe* partial operator under
    the router, then a key-grouped merge operator that recombines the
    partials. This helper wires that shape — ``partial_op`` under
    ``algorithm`` feeding ``merge_op`` under a table planner (the merge
    stage sees each key on one task again, so any planner applies).

    ``stage_kwargs`` pass through to both :func:`keyed_stage` calls
    (``window=``, ``state_backend=``, ``device=``, ...). The merge stage is
    seeded ``seed + 1``.
    """
    return Topology([
        StageSpec("split", keyed_stage(partial_op, n_tasks, theta_max,
                                       algorithm=algorithm, seed=seed,
                                       **stage_kwargs)),
        StageSpec("merge", keyed_stage(merge_op, merge_tasks or n_tasks,
                                       theta_max, algorithm=merge_algorithm,
                                       seed=seed + 1, **stage_kwargs)),
    ])


class Topology:
    """A chain of KeyedStages with vectorized stage-to-stage re-keying."""

    def __init__(self, stages: Sequence[StageSpec]):
        specs = list(stages)
        if not specs:
            raise ValueError("Topology needs at least one stage")
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate stage names: {names}")
        self.specs = specs
        self.reports: List[TopologyReport] = []
        # the final stage's emit stream from the last processed interval
        # (e.g. the top-k front's per-bucket maxima), for consumers/tests
        self.last_emit_keys: np.ndarray = np.zeros(0, dtype=np.int64)
        self.last_emit_values: np.ndarray = np.zeros(0, dtype=np.float64)
        self._interval = 0

    # -- introspection ---------------------------------------------------------
    @property
    def n_stages(self) -> int:
        return len(self.specs)

    @property
    def names(self) -> List[str]:
        return [s.name for s in self.specs]

    def __getitem__(self, name: str) -> KeyedStage:
        for spec in self.specs:
            if spec.name == name:
                return spec.stage
        raise KeyError(name)

    def rebalances_by_stage(self) -> Dict[str, List[int]]:
        """Stage name -> intervals (1-based) where its controller triggered.

        This is how the multi-stage tests assert rebalances fired at
        *different* stages within the same interval: intersect the lists.
        """
        return {spec.name: spec.stage.controller.triggered_intervals()
                for spec in self.specs}

    def total_state_keys(self) -> int:
        """Keyed state held across every stage's store fleet (leak checks)."""
        return sum(spec.stage.total_state_keys() for spec in self.specs)

    # -- checkpointed recovery (repro_torch.streams.checkpoint) ----------------
    def checkpoint(self):
        """Coherent pipeline snapshot: every stage at this source boundary."""
        from .checkpoint import checkpoint_topology
        return checkpoint_topology(self)

    def restore(self, ckpt) -> None:
        """Rewind every stage (and the pipeline clock) to ``ckpt``."""
        from .checkpoint import restore_topology
        restore_topology(self, ckpt)

    # -- one interval through the whole pipeline -------------------------------
    def process_interval(self, keys: np.ndarray,
                         values: Optional[np.ndarray] = None
                         ) -> TopologyReport:
        """Run one interval of source traffic through every stage.

        ``keys``/``values`` feed stage 0 (after its ``rekey``, if any); each
        subsequent stage consumes the previous stage's emit stream. Every
        stage runs its own full protocol round — stats, trigger decision,
        plan, pause/migrate/replay — against its own controller.
        """
        self._interval += 1
        cur_keys = np.asarray(keys, dtype=np.int64)
        cur_vals: Optional[np.ndarray] = values
        tuples_in = int(cur_keys.shape[0])
        stage_tuples: List[int] = []
        stage_reports: List[IntervalReport] = []
        for spec in self.specs:
            if spec.rekey is not None:
                cur_keys = np.asarray(spec.rekey(cur_keys, cur_vals),
                                      dtype=np.int64)
            stage_tuples.append(int(cur_keys.shape[0]))
            rep, cur_keys, cur_vals = spec.stage.process_interval_emits(
                cur_keys, cur_vals)
            stage_reports.append(rep)
        self.last_emit_keys, self.last_emit_values = cur_keys, cur_vals
        critical = float(sum(r.makespan + r.migration_stall
                             for r in stage_reports))
        report = TopologyReport(
            interval=self._interval, tuples_in=tuples_in,
            stage_tuples=stage_tuples, stage_reports=stage_reports,
            critical_path=critical,
            throughput=tuples_in / critical if critical > 0 else 0.0,
            migrated_bytes=float(sum(r.migrated_bytes for r in stage_reports)),
            buffered=int(sum(r.buffered for r in stage_reports)),
        )
        self.reports.append(report)
        return report
