"""Stateful operators — the paper's two real workloads (Sec. V) and the
max-mode merger.

* :class:`WordCount` — "store and aggregation on keywords" (Social data):
  per-key counts over the sliding window.
* :class:`WindowedSelfJoin` — "self-join over sliding window" (Stock data):
  each incoming tuple joins against all tuples of the same key within the
  window; join work (and hence c(k)) grows superlinearly with key frequency,
  which is exactly the skew-amplification the paper targets.
* :class:`MergeCounts` — PKG's downstream merger: a running max per key.

Each operator's windowed state is one numeric slot per (key, interval),
declared by a :class:`~repro_torch.streams.state.ColumnarSpec`. Two closed
forms serve the two backends:

* :meth:`Operator.process_interval_batch` — the columnar store fleet: one
  ``np.lexsort`` on ``(dest, key)`` yields every task's segment, every
  unique-key group and every occurrence index in a single pass; per-task
  costs are scattered with one ``np.bincount``.
* :meth:`Operator.device_finish` / :meth:`Operator.device_emit_values` — the
  device ring: float64 host arithmetic over the fused step's per-key
  integers, so reports stay bit-identical to the columnar path.

Emits: the j-th tuple of a key in an interval emits an arithmetic-
progression term, so the full emit stream (``process_interval_emits``) is
derived in closed form too. The JAX package's per-tuple ``process`` path and
object store are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from .state import ColumnarSpec


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


def _occurrence_index(inv: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """occ[i] = how many earlier tuples in the batch share keys[i]'s key:
    stable-sort positions by group, subtract group starts."""
    order = np.argsort(inv, kind="stable")
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    occ = np.empty(inv.size, dtype=np.int64)
    occ[order] = np.arange(inv.size, dtype=np.int64) - np.repeat(starts, counts)
    return occ


class Operator:
    name = "op"
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


class WordCount(Operator):
    name = "wordcount"
    columnar_needs_values = False
    device_mode = "add"
    device_unit_cost = True

    def __init__(self, bytes_per_entry: float = 16.0):
        self.bytes_per_entry = bytes_per_entry
        self.columnar_spec = ColumnarSpec(mode="add",
                                          slot_bytes=bytes_per_entry)

    def process_interval_batch(self, stores, interval, keys, dests, n_tasks,
                               values, collect_emits):
        order, _, gk, gd, counts, gidx, occ = _interval_groups(keys, dests)
        fcounts = counts.astype(np.float64)
        win0, _ = _update_by_dest(stores, interval, gk, gd, fcounts, n_tasks)
        c0s = win0.astype(np.int64)
        # emits per key are the running window totals c0+1 .. c0+m: sum and
        # last value are exact integer arithmetic
        outputs = list(zip(gk.tolist(), (c0s + counts).tolist()))
        emit_sum = float(np.dot(counts, c0s) + np.dot(counts, counts + 1) / 2.0)
        res = IntervalBatchResult(
            gk, fcounts.copy(), fcounts,
            np.bincount(gd, weights=fcounts, minlength=n_tasks),
            outputs, emit_sum)
        if not collect_emits:
            return res, None
        evals = np.empty(keys.size, dtype=np.int64)
        evals[order] = c0s[gidx] + occ + 1
        return res, (np.ones(keys.size, dtype=np.int64),
                     keys.astype(np.int64, copy=False), evals)

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
                                          bytes_per_unit=bytes_per_tuple)

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


class MergeCounts(Operator):
    """PKG's downstream merger: combines partial counts per key by a running
    max (the "max" slot fold)."""

    name = "merge"
    device_mode = "max"

    def __init__(self):
        self.bytes_per_entry = 16.0
        self.columnar_spec = ColumnarSpec(mode="max",
                                          slot_bytes=self.bytes_per_entry)

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
