"""Keyed, windowed columnar state store (paper Sec. II-A).

Each key holds one numeric slot per time interval; the store evicts state
older than ``window`` intervals after the interval closes (the paper's model:
"the task instance erases the state from T_{i-w} after finishing T_i").
``S(k, w)`` — the migration-cost weight — is the summed size over the window.

:class:`ColumnarStateStore` keeps flat arrays: a sorted key column plus a
ring of ``window + 1`` per-interval value/size columns. ``update_slots`` /
``end_interval_collect`` / migration are pure numpy, so interval boundaries
and migrations cost O(columns) vectorized work. Eviction is a column clear;
migration moves row slices as :class:`ColumnarPack` objects, the contract the
device backend's task views share. The JAX package's dict-of-objects
``TaskStateStore`` is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ColumnarSpec:
    """Slot semantics for :class:`ColumnarStateStore`.

    The columnar backend models one *numeric* slot per (key, interval):
    ``mode`` describes how a batch of ``add`` units folds into the slot
    value, ``slot_bytes`` is the size charged when a slot is first created
    (WordCount's fixed per-entry bytes) and ``bytes_per_unit`` the size
    growth per added unit (the self-join's per-stored-tuple bytes).
    """

    mode: str = "add"            # "add" | "max"
    slot_bytes: float = 0.0      # size charged when a slot is created
    bytes_per_unit: float = 0.0  # extra size per added unit


class _ColumnarKeysView:
    """Read-only ``store.keys`` surface: length, iteration, membership."""

    def __init__(self, store: "ColumnarStateStore"):
        self._store = store

    def __len__(self) -> int:
        return int(self._store._keys.size)

    def __iter__(self):
        return iter(self._store._keys.tolist())

    def __contains__(self, key) -> bool:
        return self._store._row_of(key) is not None


class ColumnarStateStore:
    """Array-native windowed state for numeric operators (one task instance).

    Layout: ``_keys`` (K,) int64 sorted ascending; ``_vals`` / ``_sizes``
    (K, window+1) float64; ``_present`` (K, window+1) bool; ``_col_iv``
    (window+1,) maps each column to the interval it currently holds (-1 =
    empty). ``window + 1`` columns because during interval ``T_i`` the live
    window still includes ``T_{i-w}`` (it is erased only *after* ``T_i``
    finishes — paper Sec. II-A), so ``w + 1`` intervals are readable at
    once. Column assignment is the ring position ``interval % (window+1)``,
    which is identical across stores of one stage, so migration moves rows
    column-for-column.

    Invariant: non-present slots hold exact 0.0 in ``_vals`` and ``_sizes``,
    so window totals and S(k, w) are plain row sums.
    """

    def __init__(self, window: int, spec: ColumnarSpec):
        if spec.mode not in ("add", "max"):
            raise ValueError(f"unknown columnar mode {spec.mode!r}")
        self.window = window
        self.spec = spec
        self._ncols = window + 1
        self._keys = np.zeros(0, dtype=np.int64)
        self._vals = np.zeros((0, self._ncols), dtype=np.float64)
        self._sizes = np.zeros((0, self._ncols), dtype=np.float64)
        self._present = np.zeros((0, self._ncols), dtype=bool)
        self._col_iv = np.full(self._ncols, -1, dtype=np.int64)
        self._clock = None            # monotonic interval high-water mark

    def _advance_clock(self, interval: int, what: str) -> int:
        """Reject non-monotonic interval arguments.

        The ring position is ``interval % (window+1)``, so writing (or
        evicting at) an interval older than one already processed would
        silently alias a live column — corrupting window totals instead of
        failing. Equal intervals are fine (macro-batches within one
        interval, update followed by the boundary collect)."""
        interval = int(interval)
        if self._clock is not None and interval < self._clock:
            raise ValueError(
                f"non-monotonic interval: {what}({interval}) after the store "
                f"already advanced to interval {self._clock}; the window "
                f"ring (size {self._ncols}) would alias a live column")
        self._clock = interval
        return interval

    # -- introspection (dict-store-compatible surface) -------------------------
    @property
    def keys(self) -> _ColumnarKeysView:
        return _ColumnarKeysView(self)

    def _row_of(self, key) -> Optional[int]:
        keys = self._keys
        if not keys.size:
            return None
        pos = int(np.searchsorted(keys, key))
        if pos < keys.size and int(keys[pos]) == key:
            return pos
        return None

    # -- batched hot-path access ----------------------------------------------
    def update_slots(self, interval: int, keys: np.ndarray, add: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Fold a batch of per-key units into interval ``interval``'s column.

        ``keys`` must be sorted unique int64; ``add`` aligned float64 (tuple
        counts for the "add" ops, per-key maxima for "max"). Returns
        ``(win_before, slot_before)``: the windowed totals (all live slots,
        current included) and the current-slot values, both *before* this
        update — exactly the ``c0`` quantities the operators' closed forms
        need. Missing keys/slots are created; slot creation charges
        ``spec.slot_bytes`` and each added unit ``spec.bytes_per_unit``.
        """
        keys = np.asarray(keys, dtype=np.int64)
        add = np.asarray(add, dtype=np.float64)
        interval = self._advance_clock(interval, "update_slots")
        c = interval % self._ncols
        if self._col_iv[c] != interval:
            # the ring slot last held interval - (window+1), which eviction
            # cleared at the previous boundary; the wipe below only does work
            # for direct-API callers that skip end_interval
            if self._col_iv[c] >= 0:
                self._vals[:, c] = 0.0
                self._sizes[:, c] = 0.0
                self._present[:, c] = False
            self._col_iv[c] = interval
        nkeys = self._keys
        if nkeys.size:
            pos = np.searchsorted(nkeys, keys)
            inb = pos < nkeys.size
            found = np.zeros(keys.size, dtype=bool)
            found[inb] = nkeys[pos[inb]] == keys[inb]
            if found.all():              # steady state: no new keys, no rescan
                rows = pos
            else:
                self._insert_rows(keys[~found])
                rows = np.searchsorted(self._keys, keys)
        else:
            self._insert_rows(keys)
            rows = np.arange(keys.size)
        win_before = self._vals[rows].sum(axis=1)
        slot_before = self._vals[rows, c].copy()
        fresh = ~self._present[rows, c]
        self._present[rows, c] = True
        grow = np.where(fresh, self.spec.slot_bytes, 0.0)
        if self.spec.mode == "add":
            self._vals[rows, c] = slot_before + add
            if self.spec.bytes_per_unit:
                grow = grow + self.spec.bytes_per_unit * add
        else:
            self._vals[rows, c] = np.maximum(slot_before, add)
        self._sizes[rows, c] += grow
        return win_before, slot_before

    def _insert_rows(self, new_keys: np.ndarray) -> None:
        """Merge-insert sorted unique ``new_keys`` as zeroed rows."""
        old = self._keys
        idx = np.searchsorted(old, new_keys)
        newpos = idx + np.arange(new_keys.size)
        total = old.size + new_keys.size
        keep = np.ones(total, dtype=bool)
        keep[newpos] = False
        keys2 = np.empty(total, dtype=np.int64)
        keys2[keep] = old
        keys2[newpos] = new_keys
        vals2 = np.zeros((total, self._ncols), dtype=np.float64)
        sizes2 = np.zeros((total, self._ncols), dtype=np.float64)
        pres2 = np.zeros((total, self._ncols), dtype=bool)
        vals2[keep] = self._vals
        sizes2[keep] = self._sizes
        pres2[keep] = self._present
        self._keys, self._vals, self._sizes, self._present = \
            keys2, vals2, sizes2, pres2

    # -- interval boundary ------------------------------------------------------
    def end_interval_collect(self, interval: int
                             ) -> Tuple[np.ndarray, np.ndarray]:
        """Evict expired columns AND return ``(keys, S(k,w))`` — one column
        clear plus one row compaction instead of a per-key pass."""
        interval = self._advance_clock(interval, "end_interval_collect")
        cutoff = interval - self.window + 1
        expire = (self._col_iv >= 0) & (self._col_iv < cutoff)
        if expire.any():
            self._vals[:, expire] = 0.0
            self._sizes[:, expire] = 0.0
            self._present[:, expire] = False
            self._col_iv[expire] = -1
            alive = self._present.any(axis=1)
            if not alive.all():
                self._keys = self._keys[alive]
                self._vals = self._vals[alive]
                self._sizes = self._sizes[alive]
                self._present = self._present[alive]
        return self._keys, self._sizes.sum(axis=1)

    def end_interval(self, interval: int) -> None:
        self.end_interval_collect(interval)

    # -- stats ------------------------------------------------------------------
    def sizes_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        return self._keys, self._sizes.sum(axis=1)

    # -- pack-based migration (paper steps 5-6) --------------------------------
    def extract_batch(self, keys: np.ndarray) -> "ColumnarPack":
        """Slice out the rows for ``keys`` (missing ones ignored) as a pack."""
        arr = np.unique(np.asarray(keys, dtype=np.int64).ravel())
        if arr.size and self._keys.size:
            pos = np.searchsorted(self._keys, arr)
            inb = pos < self._keys.size
            rows = pos[inb][self._keys[pos[inb]] == arr[inb]]
        else:
            rows = np.zeros(0, dtype=np.int64)
        pack = ColumnarPack(self._keys[rows], self._vals[rows],
                            self._sizes[rows], self._present[rows],
                            self._col_iv.copy())
        if rows.size:
            keep = np.ones(self._keys.size, dtype=bool)
            keep[rows] = False
            self._keys = self._keys[keep]
            self._vals = self._vals[keep]
            self._sizes = self._sizes[keep]
            self._present = self._present[keep]
        return pack

    def install_batch(self, pack: "ColumnarPack") -> None:
        if not pack.keys.size:
            return
        if self._keys.size and np.intersect1d(self._keys, pack.keys).size:
            dup = np.intersect1d(self._keys, pack.keys)
            raise RuntimeError(
                f"key {int(dup[0])} already present on target task")
        live = pack.col_iv >= 0
        conflict = live & (self._col_iv >= 0) & (self._col_iv != pack.col_iv)
        if conflict.any():
            raise RuntimeError(
                "columnar install across skewed interval clocks: source and "
                "target stores disagree on column contents")
        self._col_iv = np.where(live & (self._col_iv < 0), pack.col_iv,
                                self._col_iv)
        self._insert_rows(pack.keys)
        rows = np.searchsorted(self._keys, pack.keys)
        self._vals[rows] = pack.vals
        self._sizes[rows] = pack.sizes
        self._present[rows] = pack.present


@dataclasses.dataclass
class ColumnarPack:
    """In-flight migration payload for the columnar backend: row slices plus
    the source store's column->interval map (ring layouts agree across stores
    of one stage, so installs are column-aligned)."""

    keys: np.ndarray       # (M,) int64 sorted
    vals: np.ndarray       # (M, window+1) float64
    sizes: np.ndarray      # (M, window+1) float64
    present: np.ndarray    # (M, window+1) bool
    col_iv: np.ndarray     # (window+1,) int64

    @property
    def nbytes(self) -> float:
        return float(self.sizes.sum())

    def take(self, mask: np.ndarray) -> "ColumnarPack":
        mask = np.asarray(mask, dtype=bool)
        return ColumnarPack(self.keys[mask], self.vals[mask],
                            self.sizes[mask], self.present[mask], self.col_iv)

    def clone(self) -> "ColumnarPack":
        """Array-copied pack (checkpoint contract) — extraction already
        slices fresh arrays, but a checkpoint must stay installable more
        than once, and ``install_batch`` assigns the pack's rows into the
        target store, so the snapshot keeps its own buffers."""
        return ColumnarPack(self.keys.copy(), self.vals.copy(),
                            self.sizes.copy(), self.present.copy(),
                            self.col_iv.copy())
