"""State-backend protocol: how a KeyedStage's keyed state lives and moves.

:class:`~repro_torch.streams.engine.KeyedStage` is a thin router+controller
shell; everything state-shaped — store layout, interval execution,
migration, step-1 stats collection — lives behind the :class:`StateBackend`
protocol defined here. Backends are *registered* in this package's own
registry (:data:`BACKENDS`, :func:`register_backend`) and resolved by name.

The protocol (one instance per stage)::

    new_store()                         -> per-task store object
    process_interval(keys, values, collect_emits)
                                        -> IntervalReport [,emits]
    migrate(keys, old, new)             -> bytes moved (protocol steps 5-6)
    extract_batch(task, keys) / install_batch(task, pack)
                                        -> the ColumnarPack contract used by
                                           scale_to
    collect_stats(...)                  -> KeyStats (paper step 1), or
                                           SKETCH_PENDING in sketch mode

plus two classmethod selection hooks: :meth:`StateBackend.check` (raise
``ValueError`` when an explicit request is unsupported) and
:meth:`StateBackend.auto_eligible` (may ``state_backend="auto"`` pick this
backend?). Auto resolution order is device > columnar.

Two backends implement the protocol:

* :class:`ColumnarBackend` — flat per-task numpy arrays on the host, ONE
  whole-interval operator dispatch (``Operator.process_interval_batch``).
  On the ``"kernels"`` substrate its step-1 stats go through the
  ``key_stats`` kernel.
* :class:`DeviceBackend` — the dense ring of :mod:`.device` on the stage's
  device: one step per interval, relabel-only migration, the dense route
  through the routing kernel on the ``"kernels"`` substrate.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np
import torch

from ..core.balancer import Assignment, Hash32, KeyStats, metrics
from ..kernels.key_stats import key_sums
from .device import DeviceStateFleet, DeviceTaskView, _to_host
from .operators import _occurrence_index
from .state import ColumnarStateStore

#: name -> backend class. Mutated only through :func:`register_backend`.
BACKENDS: Dict[str, Type["StateBackend"]] = {}


class _SketchPending:
    """Sentinel: step-1 aggregates were streamed into the controller's
    sketch (``RebalanceController.ingest``) instead of materialized as a
    K-sized :class:`KeyStats`; ``KeyedStage._finish_interval`` closes the
    round with ``controller.on_interval(None)``."""

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return "<SKETCH_PENDING>"


SKETCH_PENDING = _SketchPending()


def register_backend(cls: Type["StateBackend"]) -> Type["StateBackend"]:
    """Register a backend class under ``cls.name`` (usable as a decorator)."""
    if not getattr(cls, "name", None):
        raise ValueError(f"{cls.__name__} needs a non-empty 'name'")
    BACKENDS[cls.name] = cls
    return cls


def backend_names() -> Tuple[str, ...]:
    """Every selectable ``state_backend`` value."""
    return tuple(sorted(set(BACKENDS) | {"auto"}))


def get_backend(name: str) -> Type["StateBackend"]:
    if name not in BACKENDS:
        raise ValueError(f"unknown state backend {name!r}; "
                         f"choose from {backend_names()}")
    return BACKENDS[name]


def resolve_backend(name: str, operator, controller,
                    device: torch.device) -> Type["StateBackend"]:
    """Map a ``state_backend=`` request to a backend class.

    Explicit names validate via :meth:`StateBackend.check` (raising
    ``ValueError`` with the reason); ``"auto"`` walks device > columnar: the
    device ring when the operator has device closed forms, the router is
    Hash32 and the stage runs on a CUDA device; else the columnar store."""
    if name != "auto":
        cls = get_backend(name)
        cls.check(operator, controller)
        return cls
    for cand in ("device", "columnar"):
        cls = get_backend(cand)
        if cls.auto_eligible(operator, controller, device):
            return cls
    raise ValueError(
        f"no state backend supports operator {type(operator).__name__}: it "
        "needs a columnar_spec (the object store is not ported yet)")


def _is_hash32(controller) -> bool:
    return isinstance(controller.assignment.hash_router, Hash32)


class StateBackend:
    """Base protocol + the shared pack-based migration executor.

    A backend instance belongs to exactly one stage and reaches the
    router/controller surface through ``self.stage`` (routing via
    ``stage._dest_batch``, report assembly via ``stage._finish_interval``,
    the pause-window bookkeeping via ``stage._pending_delta_arr``)."""

    name: str = ""

    def __init__(self, stage):
        self.stage = stage

    # -- selection hooks -------------------------------------------------------
    @classmethod
    def check(cls, operator, controller) -> None:
        """Raise ``ValueError`` when an explicit request is unsupported."""

    @classmethod
    def auto_eligible(cls, operator, controller, device) -> bool:
        """May ``state_backend='auto'`` select this backend?"""
        return False

    # -- store fleet -----------------------------------------------------------
    def new_store(self):
        raise NotImplementedError

    # -- one interval of traffic ----------------------------------------------
    def process_interval(self, keys: np.ndarray,
                         values: Optional[Sequence[Any]],
                         collect_emits: bool = False):
        raise NotImplementedError

    # -- migration (protocol steps 5-6); returns bytes moved -------------------
    def migrate(self, keys: np.ndarray, old: Assignment,
                new: Assignment) -> float:
        """Array-at-a-time: one dest() call per assignment, group-by-source
        extraction into packs, mask-split per destination, group installs."""
        src = old.dest(keys)
        dst = new.dest(keys)
        moving = src != dst
        mkeys, msrc = keys[moving], src[moving]
        total = 0.0
        installs = []
        for s in np.unique(msrc):
            pack = self.extract_batch(int(s), mkeys[msrc == s])
            if not pack.keys.size:
                continue
            total += pack.nbytes
            pdst = new.dest(pack.keys)
            for d in np.unique(pdst):
                installs.append((int(d), pack.take(pdst == d)))
        for d, pack in installs:
            self.install_batch(d, pack)
        return total

    # -- pack contract (scale_to's reconciliation sweep, tests) ----------------
    def extract_batch(self, task: int, keys: np.ndarray):
        return self.stage.stores[task].extract_batch(keys)

    def install_batch(self, task: int, pack) -> None:
        self.stage.stores[task].install_batch(pack)

    # -- paper step 1 ----------------------------------------------------------
    def collect_stats(self, acc_keys, acc_cost, acc_freq,
                      held) -> Optional[KeyStats]:
        raise NotImplementedError


class HostStoreBackend(StateBackend):
    """Shared vectorized interval loop for the host-store backends.

    Owns the macro-batch pause split (protocol steps 4/7): the first
    ``migration_batches`` of ``micro_batches`` slices buffer Delta-keys while
    migration is in flight. Outside that window the batched operators are
    batch-boundary-invariant (their per-key closed forms telescope), so the
    interval coalesces into at most two macro-dispatches:

      A. the pause window, with Delta-keys masked out and buffered;
      B. Resume — buffered tuples replayed (CURRENT assignment, which
         equals ``dests`` since F only changes at interval boundaries)
         followed by the rest of the stream.

    Subclasses provide :meth:`dispatch_batch`."""

    def process_interval(self, keys: np.ndarray,
                         values: Optional[Sequence[Any]],
                         collect_emits: bool = False):
        stage = self.stage
        iv = stage.begin_interval()
        n = int(keys.shape[0])
        task_cost = np.zeros(stage.n_tasks)
        acc_keys: List[np.ndarray] = []
        acc_cost: List[np.ndarray] = []
        acc_freq: List[np.ndarray] = []
        emit_acc: Optional[List[Tuple[np.ndarray, np.ndarray, np.ndarray]]] \
            = [] if collect_emits else None
        buffered_count = 0

        dests = stage._dest_batch(keys) if n else np.zeros(0, np.int64)

        pause_hi = stage.pause_window(n)
        if pause_hi is not None:
            head = np.arange(pause_hi)
            paused = np.isin(keys[:pause_hi], stage._pending_delta_arr)
            buffered_count = int(paused.sum())
            kept = head[~paused]
            if kept.size:
                self.dispatch_batch(iv, keys[kept], dests[kept], kept, values,
                                    task_cost, acc_keys, acc_cost, acc_freq,
                                    emit_acc)
            resume = np.concatenate([head[paused], np.arange(pause_hi, n)])
            if resume.size:
                self.dispatch_batch(iv, keys[resume], dests[resume], resume,
                                    values, task_cost, acc_keys, acc_cost,
                                    acc_freq, emit_acc)
        elif n:
            idx = np.arange(n)
            self.dispatch_batch(iv, keys, dests, idx, values, task_cost,
                                acc_keys, acc_cost, acc_freq, emit_acc)
        stage.clear_pause()

        held = [store.end_interval_collect(iv) for store in stage.stores]

        stats = self.collect_stats(acc_keys, acc_cost, acc_freq, held)
        report = stage._finish_interval(iv, n, task_cost, buffered_count,
                                        stats)
        if not collect_emits:
            return report
        ekeys, evals = _assemble_emits(emit_acc)
        return report, ekeys, evals

    def dispatch_batch(self, iv: int, bkeys: np.ndarray, bdests: np.ndarray,
                       abs_idx: np.ndarray, values: Optional[Sequence[Any]],
                       task_cost, acc_keys, acc_cost, acc_freq,
                       emit_acc=None) -> None:
        raise NotImplementedError

    # -- stats collection (paper Fig. 5 step 1), segment-sum form --------------
    def collect_stats(self, acc_keys, acc_cost, acc_freq,
                      held) -> Optional[KeyStats]:
        # The stat universe is (keys seen this interval) UNION (keys still
        # holding window state): omitting quiet stateful keys would let a
        # table cleanup strand their state on the old task.
        stage = self.stage
        seen = (np.concatenate(acc_keys) if acc_keys
                else np.zeros(0, np.int64))
        cost_parts = (np.concatenate(acc_cost) if acc_cost
                      else np.zeros(0, np.float64))
        freq_parts = (np.concatenate(acc_freq) if acc_freq
                      else np.zeros(0, np.float64))
        held_keys = np.concatenate([h[0] for h in held]) if held else \
            np.zeros(0, np.int64)
        held_sizes = np.concatenate([h[1] for h in held]) if held else \
            np.zeros(0, np.float64)
        if stage.controller.stats_mode == "sketch":
            # stream the per-(task,key) aggregates into the controller's
            # sketch instead of building the O(K) union universe. Two folds
            # per interval: traffic (cost+freq; duplicates across tasks /
            # macro-batches aggregate inside the sketch) and held state
            # sizes (zero cost: quiet keys must not displace heavy
            # hitters, but tracked keys pick up their exact S(k, w)).
            # The seen∪held invariant holds because the snapshot always
            # re-includes every current table key.
            ctrl = stage.controller
            if seen.size:
                ctrl.ingest(seen, cost_parts, freq=freq_parts)
            if held_keys.size:
                ctrl.ingest(held_keys, np.zeros(held_keys.size),
                            mem=held_sizes)
            return SKETCH_PENDING if (seen.size or held_keys.size) else None
        universe = np.union1d(seen, held_keys)
        if not universe.size:
            return None
        if (stage.substrate == "kernels" and seen.size
                and int(universe.max()) < stage.stats_dense_max
                and int(universe.min()) >= 0):
            return self._collect_stats_kernel(seen, cost_parts, freq_parts,
                                              held_keys, held_sizes)
        pos = np.searchsorted(universe, seen)
        cost = metrics.segment_sum(cost_parts, pos, universe.size)
        freq = metrics.segment_sum(freq_parts, pos, universe.size)
        mem = metrics.segment_sum(held_sizes,
                                  np.searchsorted(universe, held_keys),
                                  universe.size)
        return KeyStats(keys=universe, cost=cost, mem=mem, freq=freq)

    def _collect_stats_kernel(self, seen, cost_parts, freq_parts, held_keys,
                              held_sizes) -> KeyStats:
        """Step-1 stats through the ``key_stats`` kernel over a dense domain.

        The kernel is a weighted segment-sum, so one launch with two weights
        — per-group cost and per-group freq — yields c(k) and g(k).
        Accumulation is float32 on the device; reports therefore match the
        numpy path to ~1e-6 relative, not bit-for-bit."""
        dev = self.stage.device
        num = int(max(seen.max(initial=0), held_keys.max(initial=0))) + 1
        cost_d, freq_d = key_sums(
            torch.from_numpy(seen.astype(np.int32)).to(dev),
            torch.from_numpy(cost_parts).to(dev),
            torch.from_numpy(freq_parts).to(dev), num)
        cost = cost_d.cpu().numpy().astype(np.float64)
        freq = freq_d.cpu().numpy().astype(np.float64)
        mem = metrics.segment_sum(held_sizes, held_keys, num)
        # universe = seen ∪ held — held membership, not mem > 0: a quiet key
        # whose window fully evicted still occupies the store and must stay
        # visible to the balancer (same invariant as the numpy path)
        live = freq > 0
        live[held_keys] = True
        universe = np.nonzero(live)[0].astype(np.int64)
        return KeyStats(keys=universe, cost=cost[live], mem=mem[live],
                        freq=freq[live])


def _assemble_emits(emit_acc) -> Tuple[np.ndarray, np.ndarray]:
    """Order accumulated (positions, keys, values) chunks into the
    canonical source-position emit stream. Positions are unique per
    source tuple across chunks, and one tuple's emits are contiguous
    within a chunk, so a stable argsort reproduces stream order."""
    if not emit_acc:
        return np.zeros(0, np.int64), np.zeros(0, np.float64)
    pos = np.concatenate([p for p, _, _ in emit_acc])
    ekeys = np.concatenate([k for _, k, _ in emit_acc])
    evals = np.concatenate([v for _, _, v in emit_acc])
    order = np.argsort(pos, kind="stable")
    return ekeys[order], evals[order]


@register_backend
class ColumnarBackend(HostStoreBackend):
    """Flat per-task arrays + ONE whole-interval operator dispatch."""

    name = "columnar"

    @classmethod
    def check(cls, operator, controller):
        if getattr(operator, "columnar_spec", None) is None:
            raise ValueError(
                f"state_backend='columnar' requires an operator with a "
                f"columnar_spec; {type(operator).__name__} has none")

    @classmethod
    def auto_eligible(cls, operator, controller, device):
        return getattr(operator, "columnar_spec", None) is not None

    def new_store(self):
        return ColumnarStateStore(self.stage.window,
                                  self.stage.operator.columnar_spec)

    def dispatch_batch(self, iv, bkeys, bdests, abs_idx, values, task_cost,
                       acc_keys, acc_cost, acc_freq, emit_acc=None):
        """ONE whole-interval dispatch — the operator lexsorts on
        (dest, key) once, computes every segment's closed forms in a single
        pass, and scatters per-task costs with one ``np.bincount``."""
        stage = self.stage
        op = stage.operator
        if not op.columnar_needs_values or values is None:
            vals_b = None
        elif isinstance(values, np.ndarray):
            vals_b = values[abs_idx]
        else:
            vals_b = [values[i] for i in abs_idx.tolist()]
        res, emits = op.process_interval_batch(
            stage.stores, iv, bkeys, bdests, stage.n_tasks, vals_b,
            collect_emits=emit_acc is not None)
        task_cost += res.task_cost
        acc_keys.append(res.uniq_keys)
        acc_cost.append(res.key_cost)
        acc_freq.append(res.key_freq)
        for ok, ov in res.outputs:
            stage.outputs[ok] = ov
        stage.emitted_sum += res.emit_sum
        if emit_acc is not None:
            ecounts, ekeys, evals = emits
            if ekeys.size:
                emit_acc.append((np.repeat(abs_idx, ecounts), ekeys, evals))


@register_backend
class DeviceBackend(StateBackend):
    """Dense ring on the stage's device, one step per interval.

    All state lives in a :class:`~repro_torch.streams.device.DeviceStateFleet`
    (per-task stores are :class:`~repro_torch.streams.device.DeviceTaskView`
    windows onto it); migration relabels the host task mirror only."""

    name = "device"

    def __init__(self, stage):
        super().__init__(stage)
        self._device_seed = stage.controller.assignment.hash_router.seed
        self._fleet = DeviceStateFleet(stage.window,
                                       stage.operator.columnar_spec,
                                       stage.device)
        self._dest_dense_cache = None   # (cache key, device dests, host dests)
        self._views_made = 0

    @property
    def fleet(self) -> DeviceStateFleet:
        return self._fleet

    @classmethod
    def check(cls, operator, controller):
        if getattr(operator, "device_mode", None) is None \
                or getattr(operator, "columnar_spec", None) is None:
            raise ValueError(
                f"state_backend={cls.name!r} requires an operator with "
                f"device closed forms (device_mode + columnar_spec); "
                f"{type(operator).__name__} has none")
        if not _is_hash32(controller):
            router = controller.assignment.hash_router
            raise ValueError(
                f"state_backend={cls.name!r} requires a Hash32 router "
                f"(device-canonical fmix32); got {type(router).__name__}")

    @classmethod
    def auto_eligible(cls, operator, controller, device):
        return (getattr(operator, "columnar_spec", None) is not None
                and getattr(operator, "device_mode", None) is not None
                and _is_hash32(controller)
                and device.type == "cuda")

    def new_store(self):
        # a view's index IS the task id: during initial fleet construction
        # count views; afterwards (scale_to appends) follow the live store
        # list so shrink-then-grow reuses the freed task ids
        stage = self.stage
        idx = (len(stage.stores) if hasattr(stage, "stores")
               else self._views_made)
        self._views_made += 1
        return DeviceTaskView(self._fleet, idx)

    # -- migration: zero device work -------------------------------------------
    def migrate(self, keys: np.ndarray, old: Assignment,
                new: Assignment) -> float:
        """State is key-indexed on the device, so moving a key between tasks
        only relabels host ownership; migrated bytes come from the ``mem``
        mirror's closed-form S(k, w) (integer-valued float64, so the sum is
        exact in any order)."""
        src = old.dest(keys)
        dst = new.dest(keys)
        moving = src != dst
        mkeys = keys[moving]
        fleet = self._fleet
        total = 0.0
        if mkeys.size and fleet.domain:
            ok = (mkeys >= 0) & (mkeys < fleet.domain)
            mk = mkeys[ok]
            held = fleet.task[mk] >= 0
            hk = mk[held]
            total = float(fleet.mem[hk].sum())
            fleet.task[hk] = dst[moving][ok][held].astype(np.int32)
        return total

    # -- dense routing table ---------------------------------------------------
    def _dest_dense_arrays(self):
        """Dense F(k) table over every key id, refreshed once per
        ``assignment_version`` (and per domain growth), padded to the
        stage's power-of-two high-water table capacity."""
        stage = self.stage
        assignment = stage.controller.assignment
        needed = max(128, 1 << max(0, assignment.table_size - 1).bit_length())
        if needed > stage._table_capacity:
            stage._table_capacity = needed
        cache_key = (stage.controller.assignment_version,
                     assignment.table_size, stage._table_capacity,
                     self._fleet.domain, stage.n_tasks)
        if self._dest_dense_cache is None \
                or self._dest_dense_cache[0] != cache_key:
            tk, td = assignment.table_arrays(stage._table_capacity)
            dev = self._fleet.route_dense(
                tk, td, assignment.n_dest, seed=self._device_seed,
                use_kernel=(stage.substrate == "kernels"))
            self._dest_dense_cache = (cache_key, dev,
                                      self._fleet.dest_host_dense(dev))
        return self._dest_dense_cache[1], self._dest_dense_cache[2]

    # -- one interval as ONE device step ---------------------------------------
    def process_interval(self, keys: np.ndarray,
                         values: Optional[Sequence[Any]] = None,
                         collect_emits: bool = False):
        """The pause-window macro-batch split of the host path telescopes
        for device operators (their closed forms are batch-boundary
        invariant), so only the ``buffered`` count needs the host split; the
        step itself sees the whole interval."""
        stage = self.stage
        iv = stage.begin_interval()
        n = int(keys.shape[0])
        fleet = self._fleet
        op = stage.operator
        spec = op.columnar_spec

        buffered_count = 0
        pause_hi = stage.pause_window(n)
        if pause_hi is not None:
            buffered_count = int(np.isin(keys[:pause_hi],
                                         stage._pending_delta_arr).sum())
        stage.clear_pause()

        # ring-column bookkeeping (host mirror of the columnar _col_iv)
        w1 = stage.window + 1
        c = iv % w1
        col_iv = fleet.col_iv
        if n:
            if col_iv[c] not in (-1, iv):
                raise RuntimeError(
                    f"device ring column clock skew: column {c} still holds "
                    f"interval {int(col_iv[c])} at interval {iv}")
            col_iv[c] = iv
        cutoff = iv - stage.window + 1
        expire = (col_iv >= 0) & (col_iv < cutoff)
        keep = (~expire).astype(np.int32)
        col_iv[expire] = -1

        task_cost = np.zeros(stage.n_tasks)
        stats: Optional[KeyStats] = None
        win0_h = slot0_h = None

        if n:
            kmin, kmax = int(keys.min()), int(keys.max())
            if kmin < 0:
                raise ValueError(
                    f"state_backend={self.name!r} requires non-negative key "
                    f"ids; got {kmin}")
            if kmax >= stage.device_domain_max:
                raise ValueError(
                    f"key id {kmax} exceeds device_domain_max="
                    f"{stage.device_domain_max}: the dense device backend "
                    "allocates state per key id — raise device_domain_max or "
                    "use the columnar backend for sparse huge domains")
            fleet.ensure_domain(kmax + 1)
            dest_dev, dest_host = self._dest_dense_arrays()
            tv = None
            if op.device_mode == "max":
                tv64 = np.asarray(values).astype(np.int64)
                if tv64.size and not (
                        int(tv64.min()) > np.iinfo(np.int32).min
                        and int(tv64.max()) <= np.iinfo(np.int32).max):
                    raise ValueError(
                        f"state_backend={self.name!r} folds values in "
                        "int32; tuple value out of int32 range")
                tv = tv64
            step = fleet.interval_step(keys, tv, dest_dev, stage.n_tasks,
                                       keep, c, op.device_mode)
            dom = fleet.domain
            counts_h = _to_host(step[0])[:dom]
            win0_h = _to_host(step[1])[:dom]
            slot0_h = _to_host(step[2])[:dom]
            held_cnt = _to_host(step[3])[:dom]
            held_sum = _to_host(step[4])[:dom]

            seen_mask = counts_h > 0
            gk = np.nonzero(seen_mask)[0].astype(np.int64)
            key_cost_g, out_vals, emit_sum = op.device_finish(
                counts_h[seen_mask].astype(np.int64),
                win0_h[seen_mask].astype(np.int64),
                slot0_h[seen_mask].astype(np.int64))
            if out_vals is not None:
                stage.outputs.update(zip(gk.tolist(), out_vals.tolist()))
            stage.emitted_sum += emit_sum
            if op.device_unit_cost:
                if step[5] is not None:           # max mode: device bincount
                    task_cost = _to_host(step[5]).astype(np.float64)
                else:                             # add mode: counts are host
                    task_cost = np.bincount(dest_host[:dom],
                                            weights=counts_h,
                                            minlength=stage.n_tasks)
            else:
                task_cost = np.bincount(dest_host[gk], weights=key_cost_g,
                                        minlength=stage.n_tasks)

            # host mirrors: ownership labels (new keys adopt F(k); evicted
            # keys clear) and the closed-form S(k, w) per key
            alive = held_cnt > 0
            t = fleet.task
            t[:dom] = np.where(alive,
                               np.where(t[:dom] >= 0, t[:dom],
                                        dest_host[:dom].astype(np.int32)),
                               -1)
            fleet.mem[:dom] = (spec.slot_bytes * held_cnt
                               + spec.bytes_per_unit * held_sum)
            fleet.mem[:dom][~alive] = 0.0

            # stat universe = seen ∪ held == alive: a seen key's current slot
            # never expires at its own boundary, so seen ⊆ held-after
            uni = np.nonzero(alive)[0].astype(np.int64)
            if uni.size:
                cost = np.zeros(uni.size, dtype=np.float64)
                cost[np.searchsorted(uni, gk)] = key_cost_g
                if stage.controller.stats_mode == "sketch":
                    # one fold with every channel: the step already
                    # aggregated per key, so this is the same multiset the
                    # host backends stream in (see HostStoreBackend)
                    stage.controller.ingest(
                        uni, cost, mem=fleet.mem[uni],
                        freq=counts_h[alive].astype(np.float64))
                    stats = SKETCH_PENDING
                else:
                    stats = KeyStats(keys=uni,
                                     cost=cost,
                                     mem=fleet.mem[uni].copy(),
                                     freq=counts_h[alive].astype(np.float64))
        else:
            if fleet.domain and expire.any():
                held_cnt, held_sum = fleet.evict(keep)
                dom = fleet.domain
                alive = held_cnt[:dom] > 0
                fleet.task[:dom] = np.where(alive, fleet.task[:dom], -1)
                fleet.mem[:dom] = (spec.slot_bytes * held_cnt[:dom]
                                   + spec.bytes_per_unit * held_sum[:dom])
                fleet.mem[:dom][~alive] = 0.0
            stats = self.collect_stats(None, None, None, None)

        report = stage._finish_interval(iv, n, task_cost, buffered_count,
                                        stats)
        if not collect_emits:
            return report
        if n == 0:
            return report, np.zeros(0, np.int64), np.zeros(0, np.float64)
        _, inv, ucounts = np.unique(keys, return_inverse=True,
                                    return_counts=True)
        occ = _occurrence_index(inv, ucounts)
        evals = op.device_emit_values(keys, occ, win0_h, slot0_h)
        if evals is None:
            return report, np.zeros(0, np.int64), np.zeros(0, np.float64)
        return report, keys.astype(np.int64, copy=False), evals

    def collect_stats(self, acc_keys, acc_cost, acc_freq,
                      held) -> Optional[KeyStats]:
        """Quiet-interval stats straight off the host mirrors (the traffic
        path builds its stats inline from the step's outputs)."""
        fleet = self._fleet
        if not fleet.domain:
            return None
        uni = np.nonzero(fleet.task[:fleet.domain] >= 0)[0].astype(np.int64)
        if not uni.size:
            return None
        if self.stage.controller.stats_mode == "sketch":
            self.stage.controller.ingest(uni, np.zeros(uni.size),
                                         mem=fleet.mem[uni])
            return SKETCH_PENDING
        return KeyStats(keys=uni, cost=np.zeros(uni.size),
                        mem=fleet.mem[uni].copy(), freq=np.zeros(uni.size))
