"""Stream operators — the paper's two real workloads (Sec. V), PKG's split
and merge operators, and a stateless selection.

* :class:`WordCount` — "store and aggregation on keywords" (Social data):
  per-key counts over the sliding window.
* :class:`WindowedSelfJoin` — "self-join over sliding window" (Stock data):
  each incoming tuple joins against all tuples of the same key within the
  window; join work (and hence c(k)) grows superlinearly with key frequency,
  which is exactly the skew-amplification the paper targets.
* :class:`PartialWordCount` — PKG's split-key word count: partial counts
  per interval slice that a downstream stage merges (split-safe).
* :class:`MergeCounts` — PKG's downstream merger: a running max per key.
* :class:`Filter` — stateless selection ahead of a keyed stage.

Every operator has three forms, one per kind of store:

* :meth:`Operator.process` — one tuple against the object store
  (:class:`~repro_torch.streams.state.TaskStateStore`): the per-tuple
  reference loop (``KeyedStage(vectorized=False)``). Custom operators need
  only this; the base class's :meth:`Operator.process_batch` /
  :meth:`Operator.process_batch_emits` then loop over it, so they stay
  correct (not fast) on the object backend's per-task dispatch. The
  built-ins override both with closed forms: a key hit ``m`` times in a
  segment updates its state once and derives the same emits and costs.

Each built-in's windowed state is also one numeric slot per (key,
interval), declared by a :class:`~repro_torch.streams.state.ColumnarSpec`,
so two more closed forms serve the array backends:

* :meth:`Operator.process_interval_batch` — the columnar store fleet: one
  ``np.lexsort`` on ``(dest, key)`` yields every task's segment, every
  unique-key group and every occurrence index in a single pass; per-task
  costs are scattered with one ``np.bincount``.
* :meth:`Operator.device_finish` / :meth:`Operator.device_emit_values` — the
  device ring: float64 host arithmetic over the fused step's per-key
  integers, so reports stay bit-identical to the columnar path.

Emits: the j-th tuple of a key in an interval emits an arithmetic-
progression term, so the full emit stream (``process_interval_emits``) is
derived in closed form too; a multi-stage topology chains stages through
it. Set ``needs_values = False`` on operators whose ``process_batch`` never
reads tuple payloads, so the object backend skips gathering them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from .state import ColumnarSpec, TaskStateStore


@dataclasses.dataclass
class BatchResult:
    """What one :meth:`Operator.process_batch` call produced.

    The engine folds these straight into its array accumulators (per-task
    cost, per-key cost/freq via ``np.add.at``) — no per-tuple Python on the
    hot path.

    Attributes:
      uniq_keys: (U,) int64 — unique keys of the segment, sorted ascending.
      key_cost:  (U,) float64 — summed c(k) contribution per unique key.
      key_freq:  (U,) float64 — tuple count per unique key.
      task_cost: total cost charged to the task (== key_cost.sum()).
      outputs:   final (key, value) emit per key — the last emit the
                 per-tuple path would have written (downstream is last-wins).
      emit_sum:  sum of *all* numeric emitted values the per-tuple path
                 would have produced (not just the final ones).
    """

    uniq_keys: np.ndarray
    key_cost: np.ndarray
    key_freq: np.ndarray
    task_cost: float
    outputs: List[Tuple[int, Any]]
    emit_sum: float


@dataclasses.dataclass
class IntervalBatchResult:
    """What one :meth:`Operator.process_interval_batch` call produced.

    ``uniq_keys``/``key_cost``/``key_freq`` are ordered by ``(dest, key)``;
    ``task_cost`` is the full per-task cost vector; ``outputs`` is the final
    (key, value) emit per key (downstream is last-wins); ``emit_sum`` the sum
    of *all* numeric emitted values.
    """

    uniq_keys: np.ndarray          # (U,) int64 groups, (dest, key)-sorted
    key_cost: np.ndarray           # (U,) float64
    key_freq: np.ndarray           # (U,) float64
    task_cost: np.ndarray          # (n_tasks,) float64
    outputs: List[Tuple[int, Any]]
    emit_sum: float


def _interval_groups(keys: np.ndarray, dests: np.ndarray):
    """One lexsort over a whole macro-batch -> every segment's closed-form
    inputs: ``(order, starts, gk, gd, counts, gidx, occ)``.

    ``order`` sorts positions by ``(dest, key)`` (stable); groups are the
    maximal runs sharing both. ``gk``/``gd``/``counts`` describe each group,
    ``gidx`` maps each sorted position to its group, and ``occ`` is the
    occurrence index within the group (stream order).
    """
    order = np.lexsort((keys, dests))
    sk = keys[order]
    sd = dests[order]
    n = sk.size
    newgrp = np.empty(n, dtype=bool)
    newgrp[0] = True
    np.logical_or(sk[1:] != sk[:-1], sd[1:] != sd[:-1], out=newgrp[1:])
    starts = np.nonzero(newgrp)[0]
    counts = np.diff(np.append(starts, n))
    gidx = np.cumsum(newgrp) - 1
    occ = np.arange(n, dtype=np.int64) - starts[gidx]
    return order, starts, sk[starts], sd[starts], counts, gidx, occ


def _update_by_dest(stores, interval: int, gk: np.ndarray, gd: np.ndarray,
                    add: np.ndarray, n_tasks: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Apply per-(dest, key) group updates store by store (``gd`` is sorted,
    so each destination's groups are one contiguous slice). Returns the
    concatenated ``(win_before, slot_before)`` arrays aligned with the
    groups."""
    win0 = np.empty(gk.size, dtype=np.float64)
    slot0 = np.empty(gk.size, dtype=np.float64)
    bounds = np.searchsorted(gd, np.arange(n_tasks + 1))
    for d in range(n_tasks):
        s0, s1 = int(bounds[d]), int(bounds[d + 1])
        if s0 == s1:
            continue
        win0[s0:s1], slot0[s0:s1] = stores[d].update_slots(
            interval, gk[s0:s1], add[s0:s1])
    return win0, slot0


def _counting_interval_batch(stores, interval: int, keys: np.ndarray,
                             dests: np.ndarray, n_tasks: int,
                             collect_emits: bool, window_total: bool):
    """Whole-interval dispatch shared by the counting family.

    WordCount and PartialWordCount differ only in which ``c0`` their emit
    progression starts from: the windowed total (``window_total=True``) or
    the current interval slice (False). Everything else — one lexsort, one
    ``update_slots`` slice per destination, one ``np.bincount`` scatter,
    arithmetic-progression emits — is identical.
    """
    order, _, gk, gd, counts, gidx, occ = _interval_groups(keys, dests)
    fcounts = counts.astype(np.float64)
    win0, slot0 = _update_by_dest(stores, interval, gk, gd, fcounts, n_tasks)
    c0s = (win0 if window_total else slot0).astype(np.int64)
    # emits per key are the running totals c0+1 .. c0+m: sum and last value
    # are exact integer arithmetic
    outputs = list(zip(gk.tolist(), (c0s + counts).tolist()))
    emit_sum = float(np.dot(counts, c0s) + np.dot(counts, counts + 1) / 2.0)
    res = IntervalBatchResult(
        gk, fcounts.copy(), fcounts,
        np.bincount(gd, weights=fcounts, minlength=n_tasks),
        outputs, emit_sum)
    if not collect_emits:
        return res, None
    # the j-th occurrence of a key emits its running total c0 + j
    evals = np.empty(keys.size, dtype=np.int64)
    evals[order] = c0s[gidx] + occ + 1
    return res, (np.ones(keys.size, dtype=np.int64),
                 keys.astype(np.int64, copy=False), evals)


def _occurrence_index(inv: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """occ[i] = how many earlier tuples in the batch share keys[i]'s key:
    stable-sort positions by group, subtract group starts."""
    order = np.argsort(inv, kind="stable")
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    occ = np.empty(inv.size, dtype=np.int64)
    occ[order] = np.arange(inv.size, dtype=np.int64) - np.repeat(starts, counts)
    return occ


def _numeric_emit_sum(vals) -> float:
    """Sum of emitted values the JAX package's per-tuple path counts as
    numeric: its rule is ``isinstance(v, (int, float))``, so numpy float
    scalars count but numpy integer scalars do not — float arrays sum and
    integer/bool arrays contribute nothing."""
    if isinstance(vals, np.ndarray):
        if vals.dtype.kind == "f":
            return float(vals.sum())
        if vals.dtype.kind in "iub":
            return 0.0
    return float(sum(float(v) for v in vals if isinstance(v, (int, float))))


def _group_values(inv: np.ndarray, counts: np.ndarray,
                  values: Sequence[Any]) -> List[List[Any]]:
    """Split ``values`` into per-unique-key lists (stream order preserved)."""
    order = np.argsort(inv, kind="stable")
    bounds = np.concatenate(([0], np.cumsum(counts)))
    if isinstance(values, np.ndarray):
        vs = values[order]
        return [vs[bounds[u]:bounds[u + 1]].tolist()
                for u in range(len(counts))]
    return [[values[i] for i in order[bounds[u]:bounds[u + 1]]]
            for u in range(len(counts))]


class Operator:
    name = "op"
    #: set False when ``process_batch`` never reads tuple payloads — lets the
    #: object backend skip gathering per-segment value lists entirely.
    needs_values = True
    #: one numeric slot per (key, interval); see ColumnarSpec
    columnar_spec: Optional[ColumnarSpec] = None
    #: whether the columnar whole-interval path reads tuple payloads
    columnar_needs_values = True
    #: "add" / "max" when the slot fold has a device closed form (must match
    #: ``columnar_spec.mode``); None = no device form, so the device backend
    #: refuses the operator.
    device_mode: Optional[str] = None
    #: True when per-key cost == tuple frequency (1.0 cost units per tuple):
    #: task loads then come straight off the per-key counts.
    device_unit_cost = False
    #: True when the operator stays correct if one key's tuples are split
    #: across tasks (per-tuple output, or a commutative merge a downstream
    #: stage can combine). Choice routers (pkg/potc/wchoices) split keys by
    #: design, so KeyedStage refuses ``split_safe = False`` operators under
    #: a ``needs_merge_stage`` strategy — pair them with a downstream merge
    #: stage instead (see :mod:`repro_torch.streams.topology`).
    split_safe = False

    def process_interval_batch(self, stores, interval: int, keys: np.ndarray,
                               dests: np.ndarray, n_tasks: int,
                               values: Optional[Sequence[Any]],
                               collect_emits: bool):
        """Whole-interval single dispatch over the columnar store fleet.

        Returns ``(IntervalBatchResult, emits)`` where ``emits`` is the
        ``(emit_counts, emit_keys, emit_values)`` triple in input order when
        ``collect_emits`` is true, else None.
        """
        raise NotImplementedError

    def device_finish(self, counts: np.ndarray, win0: np.ndarray,
                      slot0: np.ndarray
                      ) -> Tuple[np.ndarray, Optional[np.ndarray], float]:
        """Host closed forms over the fused step's per-key integers.

        Arguments are (m,) int64 arrays for the keys SEEN this interval
        (sorted ascending): tuple counts, windowed totals before the update,
        and current-slot totals before the update. Returns
        ``(key_cost float64, output_values int64 or None, emit_sum)``.
        """
        raise NotImplementedError

    def device_emit_values(self, keys: np.ndarray, occ: np.ndarray,
                           win0_dense: np.ndarray, slot0_dense: np.ndarray
                           ) -> Optional[np.ndarray]:
        """Per-tuple emit values (input order) from dense step outputs.

        ``occ`` is each tuple's occurrence index within its key;
        ``win0_dense``/``slot0_dense`` are the step's (domain,) pre-update
        totals indexed by key id. None = the operator emits nothing.
        """
        raise NotImplementedError

    def process(self, store: TaskStateStore, interval: int, key: int,
                value: Any) -> Tuple[List[Tuple[int, Any]], float]:
        """Returns (output tuples, cost units consumed)."""
        raise NotImplementedError

    def process_batch(self, store: TaskStateStore, interval: int,
                      keys: np.ndarray,
                      values: Optional[Sequence[Any]]) -> BatchResult:
        """Process one task's micro-batch segment; default per-tuple fallback.

        Semantically equivalent to calling :meth:`process` for each tuple in
        stream order — delegates to :meth:`process_batch_emits` (one shared
        accumulation loop) and drops the emit stream. Built-in operators
        override both with vectorized closed forms; custom operators inherit
        the loop and remain correct.
        """
        res, _, _, _ = self.process_batch_emits(store, interval, keys, values)
        return res

    def process_batch_emits(self, store: TaskStateStore, interval: int,
                            keys: np.ndarray,
                            values: Optional[Sequence[Any]]
                            ) -> Tuple[BatchResult, np.ndarray, np.ndarray,
                                       np.ndarray]:
        """Like :meth:`process_batch`, plus the full emit stream.

        Returns ``(result, emit_counts, emit_keys, emit_values)``:
        ``emit_counts`` is (len(keys),) int64 — emits produced by each input
        tuple; ``emit_keys``/``emit_values`` list those emits in input order
        (all emits of tuple i precede those of tuple i+1, each a scalar).
        The engine uses this to hand a stage's output to the next stage of a
        Topology as arrays. The state update happens exactly once — callers
        invoke either this or ``process_batch``, never both. Default:
        per-tuple fallback; built-ins override with closed forms.
        """
        key_cost: dict = {}
        key_freq: dict = {}
        outputs: dict = {}
        emit = 0.0
        total = 0.0
        n = len(keys)
        counts = np.zeros(n, dtype=np.int64)
        ekeys: List[int] = []
        evals: List[Any] = []
        vals = values if values is not None else [None] * n
        for i, (k, v) in enumerate(zip(keys.tolist(), vals)):
            outs, cost = self.process(store, interval, k, v)
            total += cost
            key_cost[k] = key_cost.get(k, 0.0) + cost
            key_freq[k] = key_freq.get(k, 0.0) + 1.0
            counts[i] = len(outs)
            for ok, ov in outs:
                outputs[ok] = ov
                ekeys.append(ok)
                evals.append(ov)
                if isinstance(ov, (int, float)):
                    emit += float(ov)
        uniq = np.fromiter(sorted(key_cost), dtype=np.int64, count=len(key_cost))
        res = BatchResult(
            uniq_keys=uniq,
            key_cost=np.fromiter((key_cost[int(k)] for k in uniq),
                                 dtype=np.float64, count=len(uniq)),
            key_freq=np.fromiter((key_freq[int(k)] for k in uniq),
                                 dtype=np.float64, count=len(uniq)),
            task_cost=total, outputs=list(outputs.items()), emit_sum=emit)
        return (res, counts, np.asarray(ekeys, dtype=np.int64),
                np.asarray(evals))


class WordCount(Operator):
    name = "wordcount"
    needs_values = False
    columnar_needs_values = False
    device_mode = "add"
    device_unit_cost = True

    def __init__(self, bytes_per_entry: float = 16.0):
        self.bytes_per_entry = bytes_per_entry
        self.columnar_spec = ColumnarSpec(mode="add",
                                          slot_bytes=bytes_per_entry)

    def process(self, store, interval, key, value):
        ks = store.state(key)
        sl = ks.slice_for(interval, init=lambda: {"count": 0},
                          size=self.bytes_per_entry)
        sl.payload["count"] += 1
        total = sum(s.payload["count"] for s in ks.iter_window())
        return [(key, total)], 1.0

    def _apply_counts(self, store, interval, uniq, counts):
        """One state update per unique key; returns pre-batch window totals."""
        pairs = store.update_many(interval, uniq, init=lambda: {"count": 0},
                                  size=self.bytes_per_entry)
        c0s = np.empty(len(uniq), dtype=np.int64)
        for i, (m, (ks, sl)) in enumerate(zip(counts.tolist(), pairs)):
            c0 = 0
            for s in ks.slices.values():
                c0 += s.payload["count"]
            sl.payload["count"] += m
            c0s[i] = c0
        return c0s

    def _batch_result(self, uniq, counts, c0s, n):
        # emits per key are the running totals c0+1 .. c0+m: their sum and
        # the final (last-wins) value are exact integer arithmetic
        totals = c0s + counts
        outputs = list(zip(uniq.tolist(), totals.tolist()))
        emit = float(np.dot(counts, c0s) + np.dot(counts, counts + 1) / 2.0)
        freq = counts.astype(np.float64)
        return BatchResult(uniq, freq.copy(), freq, float(n), outputs, emit)

    def process_batch(self, store, interval, keys, values):
        # m tuples on a key whose window already counts c0 emit the running
        # totals c0+1 .. c0+m; one state update per unique key.
        uniq, counts = np.unique(keys, return_counts=True)
        c0s = self._apply_counts(store, interval, uniq, counts)
        return self._batch_result(uniq, counts, c0s, len(keys))

    def process_batch_emits(self, store, interval, keys, values):
        uniq, inv, counts = np.unique(keys, return_inverse=True,
                                      return_counts=True)
        c0s = self._apply_counts(store, interval, uniq, counts)
        res = self._batch_result(uniq, counts, c0s, len(keys))
        # the j-th occurrence of a key emits its running total c0 + j
        evals = c0s[inv] + _occurrence_index(inv, counts) + 1
        return (res, np.ones(len(keys), dtype=np.int64),
                keys.astype(np.int64, copy=False), evals)

    def process_interval_batch(self, stores, interval, keys, dests, n_tasks,
                               values, collect_emits):
        return _counting_interval_batch(stores, interval, keys, dests,
                                        n_tasks, collect_emits,
                                        window_total=True)

    def device_finish(self, counts, win0, slot0):
        emit = float(np.dot(counts, win0) + np.dot(counts, counts + 1) / 2.0)
        return counts.astype(np.float64), win0 + counts, emit

    def device_emit_values(self, keys, occ, win0_dense, slot0_dense):
        # the j-th occurrence of a key emits its running window total c0 + j
        return win0_dense[keys].astype(np.int64) + occ + 1


class WindowedSelfJoin(Operator):
    name = "selfjoin"
    #: matches and costs come from per-slot tuple COUNTS; the raw tuple
    #: payloads are not retained (nothing downstream reads them)
    columnar_needs_values = False
    device_mode = "add"

    def __init__(self, bytes_per_tuple: float = 32.0, probe_cost: float = 0.01):
        self.bytes_per_tuple = bytes_per_tuple
        self.probe_cost = probe_cost
        self.columnar_spec = ColumnarSpec(mode="add", slot_bytes=0.0,
                                          bytes_per_unit=bytes_per_tuple,
                                          payload="tuples")

    def process(self, store, interval, key, value):
        ks = store.state(key)
        matches = 0
        for sl in ks.iter_window():
            matches += len(sl.payload)
        cur = ks.slice_for(interval, init=list, size=0.0)
        cur.payload.append(value)
        cur.size += self.bytes_per_tuple
        # one output per match; cost = insert + probes over window
        cost = 1.0 + self.probe_cost * matches
        return [(key, matches)], cost

    def _batch_core(self, store, interval, keys, values, uniq, inv, counts):
        # the j-th of m tuples on a key with c0 window entries probes
        # c0 + (j-1) matches, so total probes = m*c0 + m(m-1)/2 and the last
        # emit is c0 + m - 1; cost = m inserts + probe_cost * total probes.
        grouped = _group_values(inv, counts, values)
        pairs = store.update_many(interval, uniq, init=list, size=0.0)
        outputs = []
        emit = 0.0
        key_cost = np.empty(len(uniq), dtype=np.float64)
        c0s = np.empty(len(uniq), dtype=np.int64)
        for u, (k, m, (ks, cur)) in enumerate(
                zip(uniq.tolist(), counts.tolist(), pairs)):
            c0 = sum(len(sl.payload) for sl in ks.iter_window())
            cur.payload.extend(grouped[u])
            cur.size += self.bytes_per_tuple * m
            probes = m * c0 + m * (m - 1) / 2.0
            emit += probes
            outputs.append((k, c0 + m - 1))
            key_cost[u] = m * 1.0 + self.probe_cost * probes
            c0s[u] = c0
        res = BatchResult(uniq, key_cost, counts.astype(np.float64),
                          float(key_cost.sum()), outputs, emit)
        return res, c0s

    def process_batch(self, store, interval, keys, values):
        uniq, inv, counts = np.unique(keys, return_inverse=True,
                                      return_counts=True)
        res, _ = self._batch_core(store, interval, keys, values, uniq, inv,
                                  counts)
        return res

    def process_batch_emits(self, store, interval, keys, values):
        uniq, inv, counts = np.unique(keys, return_inverse=True,
                                      return_counts=True)
        res, c0s = self._batch_core(store, interval, keys, values, uniq, inv,
                                    counts)
        # the j-th occurrence emits its probe-time match count c0 + (j-1)
        evals = c0s[inv] + _occurrence_index(inv, counts)
        return (res, np.ones(len(keys), dtype=np.int64),
                keys.astype(np.int64, copy=False), evals)

    def process_interval_batch(self, stores, interval, keys, dests, n_tasks,
                               values, collect_emits):
        # the j-th of m tuples on a key with c0 window entries probes
        # c0 + (j-1) matches, so total probes = m*c0 + m(m-1)/2 and the last
        # emit is c0 + m - 1; cost = m inserts + probe_cost * total probes.
        order, _, gk, gd, counts, gidx, occ = _interval_groups(keys, dests)
        fcounts = counts.astype(np.float64)
        win0, _ = _update_by_dest(stores, interval, gk, gd, fcounts, n_tasks)
        c0s = win0.astype(np.int64)     # window tuple counts before the batch
        probes = counts * c0s + counts * (counts - 1) / 2.0
        key_cost = fcounts * 1.0 + self.probe_cost * probes
        outputs = list(zip(gk.tolist(), (c0s + counts - 1).tolist()))
        res = IntervalBatchResult(
            gk, key_cost, fcounts,
            np.bincount(gd, weights=key_cost, minlength=n_tasks),
            outputs, float(probes.sum()))
        if not collect_emits:
            return res, None
        evals = np.empty(keys.size, dtype=np.int64)
        evals[order] = c0s[gidx] + occ
        return res, (np.ones(keys.size, dtype=np.int64),
                     keys.astype(np.int64, copy=False), evals)

    def device_finish(self, counts, win0, slot0):
        probes = counts * win0 + counts * (counts - 1) / 2.0
        key_cost = counts * 1.0 + self.probe_cost * probes
        return key_cost, win0 + counts - 1, float(probes.sum())

    def device_emit_values(self, keys, occ, win0_dense, slot0_dense):
        # the j-th occurrence emits its probe-time match count c0 + (j-1)
        return win0_dense[keys].astype(np.int64) + occ


class PartialWordCount(Operator):
    """Split-key (PKG-style) word count: emits partial counts that must be
    merged downstream — PKG's extra merge operator (Fig. 2a)."""

    name = "partial_wordcount"
    needs_values = False
    columnar_needs_values = False
    device_mode = "add"
    device_unit_cost = True
    #: one emit per input tuple, keyed by the same key: a downstream WordCount
    #: sums the increments to exact totals no matter how the key was split
    split_safe = True

    def __init__(self, bytes_per_entry: float = 16.0):
        self.bytes_per_entry = bytes_per_entry
        self.columnar_spec = ColumnarSpec(mode="add",
                                          slot_bytes=bytes_per_entry)

    def process(self, store, interval, key, value):
        ks = store.state(key)
        sl = ks.slice_for(interval, init=lambda: {"count": 0},
                          size=self.bytes_per_entry)
        sl.payload["count"] += 1
        return [(key, sl.payload["count"])], 1.0

    def _apply_slices(self, store, interval, uniq, counts):
        """One slice update per unique key; returns pre-batch slice counts."""
        pairs = store.update_many(interval, uniq,
                                  init=lambda: {"count": 0},
                                  size=self.bytes_per_entry)
        c0s = np.empty(len(uniq), dtype=np.int64)
        for i, (m, (_, sl)) in enumerate(zip(counts.tolist(), pairs)):
            c0s[i] = sl.payload["count"]
            sl.payload["count"] = c0s[i] + m
        return c0s

    def _batch_result(self, uniq, counts, c0s, n):
        # partial counts reset per interval slice: emits c0+1 .. c0+m where
        # c0 is the *current slice* count (not the window total).
        outputs = list(zip(uniq.tolist(), (c0s + counts).tolist()))
        emit = float(np.dot(counts, c0s) + np.dot(counts, counts + 1) / 2.0)
        freq = counts.astype(np.float64)
        return BatchResult(uniq, freq.copy(), freq, float(n), outputs, emit)

    def process_batch(self, store, interval, keys, values):
        uniq, counts = np.unique(keys, return_counts=True)
        c0s = self._apply_slices(store, interval, uniq, counts)
        return self._batch_result(uniq, counts, c0s, len(keys))

    def process_batch_emits(self, store, interval, keys, values):
        uniq, inv, counts = np.unique(keys, return_inverse=True,
                                      return_counts=True)
        c0s = self._apply_slices(store, interval, uniq, counts)
        res = self._batch_result(uniq, counts, c0s, len(keys))
        evals = c0s[inv] + _occurrence_index(inv, counts) + 1
        return (res, np.ones(len(keys), dtype=np.int64),
                keys.astype(np.int64, copy=False), evals)

    def process_interval_batch(self, stores, interval, keys, dests, n_tasks,
                               values, collect_emits):
        # partial counts restart per interval slice: c0 is the CURRENT slice
        # count, not the window total
        return _counting_interval_batch(stores, interval, keys, dests,
                                        n_tasks, collect_emits,
                                        window_total=False)

    def device_finish(self, counts, win0, slot0):
        emit = float(np.dot(counts, slot0) + np.dot(counts, counts + 1) / 2.0)
        return counts.astype(np.float64), slot0 + counts, emit

    def device_emit_values(self, keys, occ, win0_dense, slot0_dense):
        return slot0_dense[keys].astype(np.int64) + occ + 1


class MergeCounts(Operator):
    """PKG's downstream merger: combines partial counts per key by a running
    max (the "max" slot fold)."""

    name = "merge"
    device_mode = "max"
    #: running max is idempotent/commutative across partial streams — but a
    #: *split* MergeCounts only sees a subset of partials per task, so this
    #: flag marks per-task safety of the fold, not exactness of a split total
    split_safe = True

    def __init__(self):
        self.bytes_per_entry = 16.0
        self.columnar_spec = ColumnarSpec(mode="max",
                                          slot_bytes=self.bytes_per_entry)

    def process(self, store, interval, key, value):
        ks = store.state(key)
        sl = ks.slice_for(interval, init=lambda: {"count": 0},
                          size=self.bytes_per_entry)
        sl.payload["count"] = max(sl.payload["count"], int(value))
        return [], 0.5

    def process_batch(self, store, interval, keys, values):
        # running max over partial counts: order-insensitive, so the batch
        # form is a single max per unique key.
        uniq, inv, counts = np.unique(keys, return_inverse=True,
                                      return_counts=True)
        grouped = _group_values(inv, counts, values)
        pairs = store.update_many(interval, uniq,
                                  init=lambda: {"count": 0},
                                  size=self.bytes_per_entry)
        for u, (_, sl) in enumerate(pairs):
            sl.payload["count"] = max(sl.payload["count"],
                                      max(int(v) for v in grouped[u]))
        freq = counts.astype(np.float64)
        return BatchResult(uniq, 0.5 * freq, freq, 0.5 * float(len(keys)),
                           [], 0.0)

    def process_batch_emits(self, store, interval, keys, values):
        # terminal operator: absorbs partials, emits nothing downstream
        res = self.process_batch(store, interval, keys, values)
        return (res, np.zeros(len(keys), dtype=np.int64),
                np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.float64))

    def process_interval_batch(self, stores, interval, keys, dests, n_tasks,
                               values, collect_emits):
        order, starts, gk, gd, counts, _, _ = _interval_groups(keys, dests)
        # per-group running max; int cast first (payloads are integers)
        vals64 = np.asarray(values).astype(np.int64)
        gmax = np.maximum.reduceat(vals64[order], starts)
        _update_by_dest(stores, interval, gk, gd, gmax.astype(np.float64),
                        n_tasks)
        fcounts = counts.astype(np.float64)
        res = IntervalBatchResult(
            gk, 0.5 * fcounts, fcounts,
            np.bincount(gd, weights=0.5 * fcounts, minlength=n_tasks),
            [], 0.0)
        if not collect_emits:
            return res, None
        return res, (np.zeros(keys.size, dtype=np.int64),
                     np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.float64))

    def device_finish(self, counts, win0, slot0):
        # terminal operator: absorbs partials, emits nothing downstream
        return 0.5 * counts.astype(np.float64), None, 0.0

    def device_emit_values(self, keys, occ, win0_dense, slot0_dense):
        return None


class Filter(Operator):
    """Stateless selection: forwards tuples whose ``(key, value)`` passes
    ``predicate``, drops the rest — the 0-or-1 fan-out case of the batched
    emit contract (a TPC-H-style selection ahead of a keyed join).

    ``predicate(keys, values) -> bool mask`` must be a vectorized,
    deterministic function of its arguments. No device closed form: a
    Filter stage runs on the columnar backend.
    """

    name = "filter"
    #: stateless, per-tuple output — any split of a key is trivially correct
    split_safe = True
    #: stateless — the columnar store is never touched, but opting in routes
    #: the stage through the whole-interval single dispatch
    columnar_spec = ColumnarSpec()

    def __init__(self, predicate, cost_per_tuple: float = 0.25):
        self.predicate = predicate
        self.cost_per_tuple = cost_per_tuple

    def process(self, store, interval, key, value):
        keep = bool(np.asarray(self.predicate(
            np.asarray([key], dtype=np.int64), np.asarray([value])))[0])
        return ([(key, value)] if keep else []), self.cost_per_tuple

    def process_batch(self, store, interval, keys, values):
        res, _, _, _ = self.process_batch_emits(store, interval, keys, values)
        return res

    def _select(self, keys, values):
        """Keep mask, kept tuples, last-wins outputs over kept tuples only
        (a dropped tuple never reaches the outputs dict), and the
        emitted-sum under the per-tuple isinstance rule on the ORIGINAL
        payloads — a Python list of ints counts, but its int64 ndarray
        conversion would not, so sum from ``values`` when the caller passed
        a non-ndarray sequence."""
        vals = (values if isinstance(values, np.ndarray)
                else np.asarray(values if values is not None
                                else [None] * len(keys)))
        keep = np.asarray(self.predicate(keys, vals), dtype=bool)
        kept_k = keys[keep]
        kept_v = vals[keep]
        outputs = []
        if kept_k.size:
            rev_uniq, rev_first = np.unique(kept_k[::-1], return_index=True)
            outputs = list(zip(rev_uniq.tolist(),
                               kept_v[::-1][rev_first].tolist()))
        if isinstance(values, np.ndarray) or values is None:
            emit_sum = _numeric_emit_sum(kept_v)
        else:
            emit_sum = _numeric_emit_sum(
                [values[i] for i in np.nonzero(keep)[0]])
        return keep, kept_k, kept_v, outputs, emit_sum

    def process_batch_emits(self, store, interval, keys, values):
        keep, kept_k, kept_v, outputs, emit_sum = self._select(keys, values)
        uniq, counts = np.unique(keys, return_counts=True)
        freq = counts.astype(np.float64)
        res = BatchResult(uniq, self.cost_per_tuple * freq, freq,
                          self.cost_per_tuple * float(len(keys)), outputs,
                          emit_sum)
        return (res, keep.astype(np.int64),
                kept_k.astype(np.int64, copy=False), kept_v)

    def process_interval_batch(self, stores, interval, keys, dests, n_tasks,
                               values, collect_emits):
        keep, kept_k, kept_v, outputs, emit_sum = self._select(keys, values)
        _, _, gk, gd, counts, _, _ = _interval_groups(keys, dests)
        fcounts = counts.astype(np.float64)
        res = IntervalBatchResult(
            gk, self.cost_per_tuple * fcounts, fcounts,
            np.bincount(gd, weights=self.cost_per_tuple * fcounts,
                        minlength=n_tasks),
            outputs, emit_sum)
        if not collect_emits:
            return res, None
        return res, (keep.astype(np.int64),
                     kept_k.astype(np.int64, copy=False), kept_v)
