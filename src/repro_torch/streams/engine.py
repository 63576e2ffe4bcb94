"""Interval-synchronous stream engine with the paper's rebalance protocol
(Fig. 5).

One keyed stage = N_D task instances consuming a key-partitioned tuple
stream under the controller's mixed assignment function F. Intervals are
discretized (paper Sec. II-A); the Pause -> migrate -> Resume protocol
buffers tuples whose key is in Delta(F, F') during the migration window
(the first ``migration_batches`` of ``micro_batches`` slices) and replays
them on Resume, while every other key flows uninterrupted.

The engine produces the performance model the benchmarks read: interval
makespan = max per-task cost + migration stall, so throughput = tuples /
makespan (relative units; the paper measures the same shape of quantity on
Storm).

:class:`KeyedStage` owns what is backend-independent: routing
(``_dest_batch``), the controller handoff and report assembly
(``_finish_interval``), the pause-window clock, elastic scaling, the
failure-injection seam and the per-tuple reference loop
(``vectorized=False``) that serves as the parity oracle. Everything
state-shaped lives behind the
:class:`~repro_torch.streams.backends.StateBackend` protocol: the object,
columnar and device backends.

Failure injection
-----------------
``stage.failpoint``, when set, is called as ``failpoint(site, stage)`` at
the engine's two crash sites: ``"deliver"`` (the interval's traffic has
arrived, nothing has mutated) and ``"mid"`` (state mutated, no report
yet). ``None`` (the default) costs one attribute test per site.
:mod:`repro_torch.streams.faults` installs its injector there and recovers
by restore and replay (:class:`~repro_torch.streams.faults.ChaosRunner`).

Tracing
-------
While a ``torch.profiler.profile`` records, each interval opens a
:mod:`repro_torch.trace` record: the stage, its device backend, the routing
table and the Mixed planner mark their host work as named ranges in the
profiler's trace (``stage.*``, ``route.*``, ``plan.*``) and count the bytes
they copy from the device to the host (``d2h_bytes``) and the planner's
trials (``plan_trials``). ``IntervalReport.trace`` holds that record: each
span's wall seconds and each count, for the interval. Without a profiler
every report's ``trace`` is ``None`` and each span costs one test of the
current record.

Choice routers
--------------
With a choice router installed (``algorithm="pkg"``, ``"potc"`` or
``"wchoices"``) ``_dest_batch`` asks the router for every tuple's
destination, once per interval batch; the router's loads advance with each
call. A router splits one key's tuples across tasks, so the stage refuses
operators that are not ``split_safe``: pair a split-safe partial operator
with a downstream merge stage
(:func:`~repro_torch.streams.topology.router_merge_topology`). Routers run
on the host stores only — the device backend refuses them, as the JAX
package's does.

Multi-stage topologies chain stages through
:meth:`KeyedStage.process_interval_emits`, and
:mod:`repro_torch.streams.checkpoint` snapshots and restores a stage or a
topology at an interval boundary.

Substrate flag
--------------
``substrate="numpy"`` (default) computes routing and step-1 stats on host
numpy. ``substrate="kernels"`` routes through the F(k) routing kernel
(:mod:`repro_torch.kernels.routing_lookup`) and, on the host-store backends
(object and columnar), aggregates step-1 stats through the ``key_stats``
kernel; the per-tuple reference loop routes through the kernel too, and
keeps its dict-based stats. The assignment's
hash router must be :class:`~repro_torch.core.balancer.Hash32` and key ids
must fit int32. Stats come back float32, so reports match numpy to ~1e-6
relative rather than bit-for-bit.

Stats mode
----------
With a ``RebalanceController(stats_mode="sketch")`` every backend streams
its step-1 aggregates through ``controller.ingest`` (a count-min sketch and
a SpaceSaving head tracker) instead of building per-key
:class:`~repro_torch.core.balancer.KeyStats`, and the round plans on the
sketch's head-only snapshot. The columnar backend then skips the
``key_stats`` kernel, as the JAX package skips its Pallas histogram.

Device
------
``device=None`` means the CUDA card and raises ``RuntimeError`` when there
is none; ``device="cpu"`` runs every kernel's plain PyTorch version on the
CPU (the tests do).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import trace
from ..core.balancer import Assignment, Hash32, KeyStats, metrics
from ..core.controller import RebalanceController
from ..kernels.routing_lookup import RoutingTable, route_keys
from .backends import SKETCH_PENDING, resolve_backend
from .device import resolve_device
from .operators import Operator

SUBSTRATES = ("numpy", "kernels")
STATE_BACKENDS = ("auto", "columnar", "object", "device", "sharded")


@dataclasses.dataclass
class IntervalReport:
    interval: int
    tuples: int
    makespan: float              # max task cost (critical path)
    migration_stall: float       # migration bytes / bandwidth
    throughput: float            # tuples / (makespan + stall)
    skewness: float              # max load / mean load
    theta: float
    migrated_bytes: float
    table_size: int
    plan_time_s: float
    buffered: int                # tuples held during Pause
    task_loads: np.ndarray
    #: under the profiler, the interval's :class:`repro_torch.trace.Record`
    #: (span seconds, counts), the controller's round included; else None.
    #: It holds the plan this interval's round ran, where ``plan_time_s``
    #: books the previous interval's
    trace: Optional[trace.Record] = None


class KeyedStage:
    """N_D task instances + controller-owned assignment (one logical operator).

    Args:
      vectorized: the array-at-a-time backends (default). ``False`` selects
        the per-tuple reference loop on the object store — same results,
        far slower; kept as the parity oracle and as executable
        documentation.
      substrate: ``"numpy"`` or ``"kernels"`` — see the module docstring.
      state_backend: ``"columnar"`` (flat per-task host arrays, one
        whole-interval operator dispatch), ``"object"`` (dict-of-KeyState
        stores, per-task segment dispatch: the only store for operators
        without a ``columnar_spec``), ``"device"`` (a dense key-indexed
        ring on ``device``, one step per interval; see
        :mod:`repro_torch.streams.device`) or ``"auto"`` (device when the
        stage is vectorized, the operator has device closed forms, the
        strategy is a table planner, the router is Hash32 and the stage
        runs on CUDA; else columnar when the operator has a
        ``columnar_spec`` and the stage is vectorized; else object).
        ``"sharded"`` splits the device ring over the ranks of the
        default ``torch.distributed`` group, one key block each
        (explicit-only; see :mod:`repro_torch.streams.sharded`).
      n_shards: the shard count of ``state_backend="sharded"``: ``None``
        means the process group's size, and any other size raises.
        Ignored by the other backends.
      device: where the device ring and the kernels run; ``None`` = CUDA.
      device_domain_max: the device and sharded backends allocate dense
        state per key id; ids at or above this bound raise.
      stats_dense_max: on the ``"kernels"`` substrate the stats kernel needs
        a dense key domain; larger domains take the numpy segment-sum.
    """

    def __init__(self, operator: Operator, controller: RebalanceController,
                 window: int = 1, migration_bandwidth: float = 1e6,
                 micro_batches: int = 8, migration_batches: int = 2,
                 vectorized: bool = True,
                 substrate: str = "numpy", state_backend: str = "auto",
                 n_shards: Optional[int] = None,
                 device=None, stats_dense_max: int = 1 << 20,
                 device_domain_max: int = 1 << 22, algorithm=None):
        if substrate not in SUBSTRATES:
            raise ValueError(f"unknown substrate {substrate!r}; "
                             f"choose from {SUBSTRATES}")
        self.device = resolve_device(device)
        self.operator = operator
        self.controller = controller
        if algorithm is not None:
            # installed before backend resolution so the backends' support
            # checks see the strategy
            controller.use_algorithm(algorithm)
        if (controller.strategy.needs_merge_stage
                and not getattr(operator, "split_safe", False)):
            raise ValueError(
                f"algorithm {controller.algorithm_name!r} splits keys across "
                f"tasks but operator {operator.name!r} is not split-safe; "
                "use a split-safe operator (e.g. PartialWordCount) with a "
                "downstream merge stage (repro_torch.streams.topology), or a "
                "table-planner algorithm")
        self.window = window
        self.n_tasks = controller.assignment.n_dest
        self.device_domain_max = device_domain_max
        self.n_shards = n_shards
        self.migration_bandwidth = migration_bandwidth
        self.micro_batches = micro_batches
        self.migration_batches = migration_batches
        self.vectorized = vectorized
        self.substrate = substrate
        self.stats_dense_max = stats_dense_max
        self.reports: List[IntervalReport] = []
        self.outputs: Dict[int, Any] = {}
        self.emitted_sum = 0.0                      # running sum of numeric emits
        self.last_stats: Optional[KeyStats] = None
        self._interval = 0
        self._pending_delta: Optional[set] = None   # paused keys (set)
        self._pending_delta_arr: Optional[np.ndarray] = None
        self._migrated_bytes_pending = 0.0
        self._plan_time_pending = 0.0
        self._table_capacity = 0      # routing-table pad, high-water mark
        self._route_cache = None      # (cache key, RoutingTable)
        #: failure-injection seam (repro_torch.streams.faults): when set,
        #: called as ``failpoint(site, stage)`` at the engine's crash points
        #: — "deliver" (before any mutation) and "mid" (state mutated, no
        #: report yet)
        self.failpoint = None
        # backend selection (and its support errors) precedes substrate init
        backend_cls = resolve_backend(state_backend, operator, controller,
                                      vectorized, self.device)
        if substrate == "kernels":
            self._init_kernels()
        self.backend = backend_cls(self)
        self.state_backend = self.backend.name
        self.stores = [self.backend.new_store() for _ in range(self.n_tasks)]
        # wire the migration executor (paper steps 5-6)
        self.controller.executor = self._execute_migration
        # the plans' psi order runs on the stage's card, where it has one
        self.controller.plan_device = (self.device
                                       if self.device.type == "cuda" else None)

    def _init_kernels(self) -> None:
        router = self.controller.assignment.hash_router
        if not isinstance(router, Hash32):
            raise ValueError(
                "substrate='kernels' requires a Hash32 router (device-"
                f"canonical fmix32); got {type(router).__name__}")
        self._hash_seed = router.seed

    # -- failure-injection seam (repro_torch.streams.faults) -------------------
    def _failpoint(self, site: str) -> None:
        if self.failpoint is not None:
            self.failpoint(site, self)

    # -- pause-window clock (protocol steps 4/7) --------------------------------
    def begin_interval(self) -> int:
        self._interval += 1
        return self._interval

    def pause_window(self, n: int) -> Optional[int]:
        """Index bound of the pause window, or None when no migration is in
        flight: the first ``migration_batches`` of ``micro_batches`` slices
        buffer Delta-keys while migration completes."""
        if not n or self._pending_delta_arr is None:
            return None
        edges = np.linspace(0, n, self.micro_batches + 1).astype(int)
        return int(edges[min(self.migration_batches, self.micro_batches)])

    def clear_pause(self) -> None:
        self._pending_delta = None
        self._pending_delta_arr = None

    # -- migration executor (paper steps 5-6) -----------------------------------
    def _execute_migration(self, moved_keys: np.ndarray, old: Assignment,
                           new: Assignment) -> None:
        """Controller-invoked: the backend moves the state, the stage books
        the stall and opens the pause window for Delta(F, F')."""
        keys = np.asarray(moved_keys, dtype=np.int64)
        self._migrated_bytes_pending += self.backend.migrate(keys, old, new)
        # the reference loop materializes the membership set lazily; the
        # vectorized backends only ever consult the array (np.isin)
        self._pending_delta = None
        self._pending_delta_arr = keys

    # -- one interval of traffic ------------------------------------------------
    def process_interval(self, tuples: Sequence[Tuple[int, Any]]
                         ) -> IntervalReport:
        """Process one interval given ``(key, value)`` tuples (list API)."""
        keys = np.fromiter((k for k, _ in tuples), dtype=np.int64,
                           count=len(tuples))
        values = [v for _, v in tuples]
        return self.process_interval_arrays(keys, values)

    def process_interval_arrays(self, keys: np.ndarray,
                                values: Optional[Sequence[Any]] = None
                                ) -> IntervalReport:
        """Array-native entry point: ``keys`` as int64 array, ``values`` as an
        aligned sequence (or None when the operator reads no payloads)."""
        previous = trace.begin()
        try:
            self._failpoint("deliver")
            if not self.vectorized:
                return self._process_interval_reference(keys, values)
            return self.backend.process_interval(keys, values)
        finally:
            trace.end(previous)

    def process_interval_emits(self, keys: np.ndarray,
                               values: Optional[Sequence[Any]] = None
                               ) -> Tuple[IntervalReport, np.ndarray,
                                          np.ndarray]:
        """Process one interval and also return the operator's emit stream
        ``(report, emit_keys, emit_values)``, ordered by source-tuple
        position (one tuple's fan-out emits stay adjacent, in emit order);
        every engine path produces this exact stream."""
        previous = trace.begin()
        try:
            self._failpoint("deliver")
            if not self.vectorized:
                return self._process_interval_reference(keys, values,
                                                        collect_emits=True)
            return self.backend.process_interval(keys, values,
                                                 collect_emits=True)
        finally:
            trace.end(previous)

    def _dest_batch(self, keys: np.ndarray) -> np.ndarray:
        """Destinations for a key batch — the strategy's per-tuple router
        when one is installed, else F(k) via numpy Assignment.dest or the
        routing kernel. Called exactly ONCE per interval batch (routers are
        stateful: their load estimates advance per call)."""
        strategy = self.controller.strategy
        if strategy.is_router:
            return strategy.route(keys)
        if self.substrate == "kernels" and keys.size:
            if int(keys.max()) > np.iinfo(np.int32).max or int(keys.min()) < 0:
                raise ValueError(
                    "substrate='kernels' requires key ids in [0, 2^31): the "
                    "routing kernel operates on int32 and larger ids would "
                    "silently alias")
            assignment = self.controller.assignment
            # pad the table to a power-of-two high-water capacity (>= 128),
            # the JAX package's retrace guard, kept so both pad alike
            needed = max(128, 1 << max(0, assignment.table_size - 1).bit_length())
            if needed > self._table_capacity:
                self._table_capacity = needed
            # device-side table cache: the controller bumps
            # assignment_version on every rebalance/rescale, so (version,
            # table_size, capacity) only moves when the table can differ
            cache_key = (self.controller.assignment_version,
                         assignment.table_size, self._table_capacity)
            if self._route_cache is None or self._route_cache[0] != cache_key:
                tk, td = assignment.table_arrays(self._table_capacity)
                self._route_cache = (
                    cache_key, RoutingTable.from_arrays(tk, td, self.device))
            table = self._route_cache[1]
            keys_dev = torch.from_numpy(keys.astype(np.int32)).to(self.device)
            out = route_keys(keys_dev, table, assignment.n_dest,
                             seed=self._hash_seed)
            return out.cpu().numpy().astype(np.int64)
        return self.controller.assignment.dest(keys)

    def _finish_interval(self, iv: int, n: int, task_cost: np.ndarray,
                         buffered_count: int,
                         stats: Optional[KeyStats]) -> IntervalReport:
        # -- measurement + controller handoff (paper steps 1-2) -----------------
        stall = self._migrated_bytes_pending / self.migration_bandwidth
        makespan = float(task_cost.max()) if n else 0.0
        report = IntervalReport(
            interval=iv, tuples=n, makespan=makespan, migration_stall=stall,
            throughput=n / (makespan + stall) if (makespan + stall) > 0 else 0.0,
            skewness=metrics.skewness(task_cost) if n else 1.0,
            theta=metrics.theta(task_cost) if n else 0.0,
            migrated_bytes=self._migrated_bytes_pending,
            table_size=self.controller.assignment.table_size,
            plan_time_s=self._plan_time_pending,
            buffered=buffered_count, task_loads=task_cost,
        )
        self.reports.append(report)
        self._migrated_bytes_pending = 0.0
        self._plan_time_pending = 0.0
        if stats is not None:
            # pin the event to the STAGE interval: a stats-free interval
            # (no tuples, no held state) skips the controller
            if stats is SKETCH_PENDING:
                # the backend streamed aggregates into the controller's
                # sketch; close the round on the head-only snapshot
                ev = self.controller.on_interval(None, interval=iv)
                self.last_stats = self.controller.last_stats
            else:
                self.last_stats = stats
                ev = self.controller.on_interval(stats, interval=iv)
            if ev.result is not None:
                self._plan_time_pending = ev.result.plan_time_s
                trials = ev.result.meta.get("trials")
                if trials is not None:
                    trace.count("plan_trials", trials)
        report.trace = trace.current()
        return report

    # -- reference per-tuple path (parity oracle; vectorized=False) ------------
    def _process_interval_reference(self, keys: np.ndarray,
                                    values: Optional[Sequence[Any]],
                                    collect_emits: bool = False):
        iv = self.begin_interval()
        n = int(keys.shape[0])
        vals = values if values is not None else [None] * n
        if self._pending_delta is None and self._pending_delta_arr is not None:
            self._pending_delta = set(self._pending_delta_arr.tolist())
        task_cost = np.zeros(self.n_tasks)
        key_cost: Dict[int, float] = defaultdict(float)
        key_freq: Dict[int, float] = defaultdict(float)
        buffer: List[Tuple[int, int, Any]] = []      # (position, key, value)
        buffered_count = 0
        emit_log: Optional[List[Tuple[int, int, Any]]] = \
            [] if collect_emits else None

        dests = self._dest_batch(keys) if n else np.zeros(0, np.int64)

        batch_edges = np.linspace(0, n, self.micro_batches + 1).astype(int)
        for b in range(self.micro_batches):
            lo, hi = batch_edges[b], batch_edges[b + 1]
            migrating = (self._pending_delta is not None
                         and b < self.migration_batches)
            if not migrating and buffer:
                # Resume: replay buffered tuples with the CURRENT assignment
                for pos, k, v in buffer:
                    d = int(self.controller.assignment.dest(
                        np.asarray([k], dtype=np.int64))[0])
                    self._run_one(d, iv, k, v, pos, task_cost, key_cost,
                                  key_freq, emit_log)
                buffer.clear()
                self.clear_pause()
            for i in range(lo, hi):
                k, v = int(keys[i]), vals[i]
                if migrating and k in self._pending_delta:
                    buffer.append((i, k, v))        # Pause: cache locally
                    buffered_count += 1
                    continue
                self._run_one(int(dests[i]), iv, k, v, i, task_cost, key_cost,
                              key_freq, emit_log)
        if buffer:                                   # traffic ended mid-pause
            for pos, k, v in buffer:
                d = int(self.controller.assignment.dest(
                    np.asarray([k], dtype=np.int64))[0])
                self._run_one(d, iv, k, v, pos, task_cost, key_cost, key_freq,
                              emit_log)
            buffer.clear()
        self.clear_pause()
        self._failpoint("mid")

        for store in self.stores:
            store.end_interval(iv)

        stats = self._collect_stats(key_cost, key_freq)
        report = self._finish_interval(iv, n, task_cost, buffered_count, stats)
        if not collect_emits:
            return report
        # canonical order = source position (replays keep their original
        # position, and a tuple's emits were appended contiguously)
        emit_log.sort(key=lambda t: t[0])
        ekeys = np.asarray([k for _, k, _ in emit_log], dtype=np.int64)
        evals = np.asarray([v for _, _, v in emit_log])
        return report, ekeys, evals

    def _run_one(self, d: int, interval: int, key: int, value: Any, pos: int,
                 task_cost, key_cost, key_freq, emit_log=None) -> None:
        outs, cost = self.operator.process(self.stores[d], interval, key, value)
        task_cost[d] += cost
        key_cost[key] += cost
        key_freq[key] += 1
        for ok, ov in outs:
            self.outputs[ok] = ov
            if isinstance(ov, (int, float)):
                self.emitted_sum += float(ov)
            if emit_log is not None:
                emit_log.append((pos, ok, ov))

    def _collect_stats(self, key_cost, key_freq) -> Optional[KeyStats]:
        # Paper step 1: every instance reports c(k) AND S(k,w) for each key
        # *assigned to it* — the stat universe is (keys seen this interval)
        # UNION (keys still holding window state). Omitting quiet stateful
        # keys would let a table cleanup strand their state on the old task.
        sizes: Dict[int, float] = {}
        for store in self.stores:
            sizes.update(store.sizes())
        universe = set(key_cost) | set(sizes)
        if not universe:
            return None
        keys = np.fromiter(sorted(universe), dtype=np.int64, count=len(universe))
        cost = np.fromiter((key_cost.get(int(k), 0.0) for k in keys),
                           dtype=np.float64)
        freq = np.fromiter((key_freq.get(int(k), 0.0) for k in keys),
                           dtype=np.float64)
        mem = np.fromiter((sizes.get(int(k), 0.0) for k in keys),
                          dtype=np.float64)
        if self.controller.stats_mode == "sketch":
            # the reference loop is dict-based (it materializes the exact
            # universe anyway), but in sketch mode it still hands off
            # through the sketch so the controller plans on the same
            # head-only contract as the vectorized backends
            self.controller.ingest(keys, cost, mem=mem, freq=freq)
            return SKETCH_PENDING
        return KeyStats(keys=keys, cost=cost, mem=mem, freq=freq)

    # -- elastic scaling (paper Fig. 15) ----------------------------------------
    def scale_to(self, n_tasks: int) -> None:
        """Add/remove task instances and rebalance state onto the new fleet.

        New stores must exist before the controller's migration executor runs;
        shrink requires draining removed stores first (state migrates away via
        the rescale plan, since no key may map to a dead task)."""
        if n_tasks < 1:
            raise ValueError(
                f"scale_to requires n_tasks >= 1, got {n_tasks}: a stage "
                "cannot run with an empty fleet")
        if self.controller.strategy.is_router:
            # fail before touching stores: controller.rescale raises, but
            # only after the fleet would already have grown
            self.controller.rescale(n_tasks, self.last_stats)
        if self.last_stats is None:
            raise RuntimeError("scale_to requires at least one processed interval")
        while len(self.stores) < n_tasks:
            self.stores.append(self.backend.new_store())
        self.controller.rescale(n_tasks, self.last_stats)
        # reconciliation sweep: the rescale executor only covers keys present
        # in the last interval's stats; stale-state keys re-hash too.
        for s_idx, store in enumerate(self.stores):
            held, _ = store.sizes_arrays()
            if not held.size:
                continue
            dst = self.controller.assignment.dest(held)
            movers = held[dst != s_idx]
            if movers.size:
                pack = store.extract_batch(movers)
                self._migrated_bytes_pending += pack.nbytes
                pdst = self.controller.assignment.dest(pack.keys)
                for d in np.unique(pdst):
                    self.stores[int(d)].install_batch(pack.take(pdst == d))
        self.stores = self.stores[:n_tasks]
        self.n_tasks = n_tasks

    # -- invariant helpers for tests -------------------------------------------
    def total_state_keys(self) -> int:
        return sum(len(s.keys) for s in self.stores)

    def key_location(self, key: int) -> List[int]:
        return [i for i, s in enumerate(self.stores) if key in s.keys]
