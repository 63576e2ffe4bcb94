"""Sketch-based controller statistics: O(head) plan rounds at huge K.

Beyond paper (cf. W-Choices, arXiv:1510.05714; PKG, arXiv:1510.07623): the
planners can only ever *act* on a handful of head keys (the routing table is
bounded by ``A_max``), yet exact step-1 measurement materializes O(K) arrays
per interval and every plan round pays O(K) time. W-Choices shows a
SpaceSaving-style heavy-hitter estimate is all a head/tail partitioner
needs, and PKG shows the tail is safely handled by hashing alone — which is
exactly the contract the planner's ``head_fraction`` split establishes:
head keys get exact LLFD/Adjust placement, tail keys stay frozen on their
hash destinations as per-destination base loads.

Three pieces, all array-native numpy:

* :class:`CountMinSketch` — ``depth`` seeded fmix32 hash rows (golden-ratio
  seed stride, the same :class:`~.hashing.Hash32` family as the choice
  routers, computed fused across rows), vectorized ``update`` via per-row
  ``np.bincount`` and ``np.minimum`` across rows on query. Never
  underestimates; overestimate is bounded by the colliding mass per row
  (~N/width in expectation).
* :class:`SpaceSavingTracker` — fixed-capacity heavy-hitter tracker in the
  mergeable Misra-Gries formulation (Agarwal et al., "Mergeable
  Summaries"): per-entry lower-bound counters plus a scalar ``offset`` that
  accumulates every truncation's subtraction. Guarantees (provable, and
  asserted by the JAX package's sketch property tests):

  - ``offset <= total / (capacity + 1)``;
  - ``estimate(k) - true(k) <= offset`` and ``estimate(k) >= true(k)``;
  - every key with ``true(k) > offset`` is tracked;
  - entries with ``err == 0`` (inserted before any truncation — which
    includes every key tracked since its first occurrence) carry **exact**
    cost/mem/freq side counters, bit-identical to dict counting.

* :class:`SketchStats` — the controller-facing adapter. ``update()`` folds
  streaming ``(keys, dests, cost, mem, freq)`` batches into the sketch, the
  tracker AND exact per-destination totals (O(n_dest) memory, so the
  trigger's theta stays exact — head estimate errors cancel against the
  derived tail base loads). ``snapshot(assignment)`` emits a head-only
  :class:`~.types.KeyStats` whose ``base_loads`` carry the frozen tail:
  the planners (mixed/mintable/minmig/readj) run unmodified on H keys
  instead of K.

Head membership: tracked heavy hitters ∪ every key currently in the routing
table. Table keys must stay visible even when quiet — the planner derives
the new table from the stats it sees (``Workspace.result_table``), so a
table key missing from the snapshot would silently drop its entry and
strand its state on the old task (the same invariant exact stats collection
keeps via the seen ∪ held universe). Table keys not tracked exactly get
count-min estimates capped at the tracker's ``offset`` bound (still never
an underestimate — both are upper bounds on an untracked key's true
weight — so migration-cost accounting stays conservative).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .hashing import GOLDEN_SEED_STRIDE, fmix32
from .types import Assignment, KeyStats

Array = np.ndarray

#: channels every sketch structure tracks alongside the balance weight
_CHANNELS = ("cost", "mem", "freq")


@dataclasses.dataclass
class SketchConfig:
    """Knobs for sketch-mode stats (``RebalanceController(stats_mode="sketch")``).

    Defaults hold the whole controller state near 2 MB regardless of K:
    one depth x width float64 plane per folded channel (~1 MB) +
    capacity-bounded tracker arrays (~0.8 MB) + O(n_dest) totals.
    ``capacity`` trades plan quality for head size: the planners can only
    move head keys, so the tracked mass fraction bounds how close a sketch
    plan can get to the exact plan's balance (16384 holds the
    strategy-matrix shapes within 10% of exact at K=1e5 — see
    the JAX package's sketch scaling benchmark).

    ``channels`` selects which per-key quantities the count-min planes
    refine. Only the cost (balance-weight) channel by default: untracked
    keys are provably light (true weight <= tracker ``offset``), the
    snapshot caps every loose cost estimate at that bound anyway, and
    their mem/freq are derived by proxy — so extra planes buy little
    precision while doubling the dominant O(K)-per-batch fold cost.
    ``depth=2`` for the same reason: with the offset cap, deeper
    ``np.minimum`` stacks only chase collision noise that is already
    bounded. Raise both for standalone CMS use.
    """

    width: int = 1 << 16       # count-min columns per row
    depth: int = 2             # independent seeded hash rows
    capacity: int = 16384      # H: max tracked heavy hitters
    channels: Tuple[str, ...] = ("cost",)   # planes folded per batch

    def __post_init__(self) -> None:
        if self.width < 16:
            raise ValueError("sketch width must be >= 16")
        if self.depth < 1:
            raise ValueError("sketch depth must be >= 1")
        if self.capacity < 1:
            raise ValueError("sketch capacity must be >= 1")
        if not self.channels or any(ch not in _CHANNELS
                                    for ch in self.channels):
            raise ValueError(f"channels must be a subset of {_CHANNELS}")


class CountMinSketch:
    """Array-native count-min sketch over int64 key ids.

    ``depth`` rows of :class:`Hash32` (seeds spaced by the golden-ratio
    stride), one ``(depth, width)`` float64 plane per channel. ``update``
    is one ``np.bincount`` per (row, channel); ``query`` takes the
    ``np.minimum`` across rows, so estimates never undercount.
    """

    def __init__(self, width: int, depth: int, seed: int = 0,
                 channels: Tuple[str, ...] = ("cost",)):
        self.width = int(width)
        self.depth = int(depth)
        # row j hashes with seed + j * golden stride — the same Hash32
        # family as the choice routers, computed fused across rows
        self._seeds = np.array(
            [(seed + j * GOLDEN_SEED_STRIDE) & 0xFFFFFFFF
             for j in range(self.depth)], dtype=np.uint32)
        self.planes = {ch: np.zeros((self.depth, self.width)) for ch in channels}

    def _indices(self, keys: Array) -> Array:
        """(depth, n) column indices: fmix32(key ^ row_seed) % width, all
        rows in one broadcast pass (bit-mask when width is a power of two)."""
        base = (keys & 0xFFFFFFFF).astype(np.uint32)
        h = fmix32(base[None, :] ^ self._seeds[:, None])
        if self.width & (self.width - 1) == 0:
            return (h & np.uint32(self.width - 1)).astype(np.int64,
                                                          copy=False)
        return (h % np.uint32(self.width)).astype(np.int64, copy=False)

    def update(self, keys: Array, **weights: Optional[Array]) -> None:
        """Fold ``weights[channel]`` (aligned with ``keys``) into each plane."""
        keys = np.asarray(keys, dtype=np.int64)
        arrs = {ch: np.asarray(w, dtype=np.float64)
                for ch, w in weights.items() if w is not None}
        for ch in arrs:
            if ch not in self.planes:
                raise KeyError(f"unknown sketch channel {ch!r}")
        if not keys.size or not arrs:
            return
        idx = self._indices(keys)
        for j in range(self.depth):
            for ch, w in arrs.items():
                self.planes[ch][j] += np.bincount(idx[j], weights=w,
                                                  minlength=self.width)

    def query(self, keys: Array, channel: str = "cost") -> Array:
        keys = np.asarray(keys, dtype=np.int64)
        if not keys.size:
            return np.zeros(0, dtype=np.float64)
        plane = self.planes[channel]
        idx = self._indices(keys)
        est = plane[0][idx[0]]
        for j in range(1, self.depth):
            est = np.minimum(est, plane[j][idx[j]])
        return est

    def reset(self) -> None:
        for plane in self.planes.values():
            plane[:] = 0.0

    # -- serialize seam (checkpointed recovery) --------------------------------
    def state_dict(self) -> dict:
        """Plain-array snapshot of the sketch (checkpoint contract)."""
        return {"width": self.width, "depth": self.depth,
                "seeds": self._seeds.copy(),
                "planes": {ch: p.copy() for ch, p in self.planes.items()}}

    def load_state_dict(self, state: dict) -> None:
        if int(state["width"]) != self.width \
                or int(state["depth"]) != self.depth:
            raise ValueError(
                f"sketch geometry mismatch: checkpoint is "
                f"{state['depth']}x{state['width']}, live sketch is "
                f"{self.depth}x{self.width}")
        self._seeds = np.asarray(state["seeds"], dtype=np.uint32).copy()
        self.planes = {ch: np.asarray(p, dtype=np.float64).copy()
                       for ch, p in state["planes"].items()}

    @property
    def nbytes(self) -> int:
        return sum(p.nbytes for p in self.planes.values())


class SpaceSavingTracker:
    """Fixed-capacity heavy-hitter tracker with exact side counters.

    SpaceSaving semantics via the mergeable Misra-Gries formulation: batch
    ``update`` merges the (deduplicated) incoming weights into the tracked
    counters, and when the entry count exceeds ``capacity`` subtracts the
    (capacity+1)-th largest counter from all of them, dropping entries that
    hit zero and adding the subtraction to the scalar ``offset``. The
    estimate of a key's true ingested weight is ``count + offset`` for
    tracked keys and ``offset`` for the rest — an upper bound with error at
    most ``offset <= total / (capacity + 1)``.

    ``err[i]`` records the offset at the entry's (re)insertion: ``err == 0``
    proves the key has been tracked since its first occurrence, making its
    ``cost``/``mem``/``freq`` side counters exact (they accumulate raw
    batch contributions and are never decremented).
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = int(capacity)
        self._keys = np.zeros(0, dtype=np.int64)       # sorted ascending
        self._count = np.zeros(0, dtype=np.float64)    # MG lower-bound counter
        self._err = np.zeros(0, dtype=np.float64)      # offset at insertion
        self._side = {ch: np.zeros(0, dtype=np.float64) for ch in _CHANNELS}
        self.offset = 0.0                              # total subtracted mass
        self.total = 0.0                               # exact ingested weight

    def __len__(self) -> int:
        return int(self._keys.size)

    @property
    def keys(self) -> Array:
        return self._keys

    @property
    def counts(self) -> Array:
        return self._count

    @property
    def err(self) -> Array:
        return self._err

    @property
    def exact_mask(self) -> Array:
        """True where the entry's side counters are provably exact."""
        return self._err == 0.0

    def side(self, channel: str) -> Array:
        return self._side[channel]

    @property
    def nbytes(self) -> int:
        return int(self._keys.nbytes + self._count.nbytes + self._err.nbytes
                   + sum(a.nbytes for a in self._side.values()))

    # -- serialize seam (checkpointed recovery) --------------------------------
    def state_dict(self) -> dict:
        """Plain-array snapshot of the tracker (checkpoint contract)."""
        return {"capacity": self.capacity, "keys": self._keys.copy(),
                "count": self._count.copy(), "err": self._err.copy(),
                "side": {ch: a.copy() for ch, a in self._side.items()},
                "offset": self.offset, "total": self.total}

    def load_state_dict(self, state: dict) -> None:
        if int(state["capacity"]) != self.capacity:
            raise ValueError(
                f"tracker capacity mismatch: checkpoint has "
                f"{state['capacity']}, live tracker has {self.capacity}")
        self._keys = np.asarray(state["keys"], dtype=np.int64).copy()
        self._count = np.asarray(state["count"], dtype=np.float64).copy()
        self._err = np.asarray(state["err"], dtype=np.float64).copy()
        self._side = {ch: np.asarray(a, dtype=np.float64).copy()
                      for ch, a in state["side"].items()}
        self.offset = float(state["offset"])
        self.total = float(state["total"])

    def estimate(self, keys: Array) -> Array:
        """Upper-bound estimate of each key's true ingested weight."""
        keys = np.asarray(keys, dtype=np.int64)
        out = np.full(keys.shape, self.offset, dtype=np.float64)
        if self._keys.size and keys.size:
            pos = np.clip(np.searchsorted(self._keys, keys), 0,
                          self._keys.size - 1)
            hit = self._keys[pos] == keys
            out[hit] = self._count[pos[hit]] + self.offset
        return out

    def update(self, keys: Array, weight: Array,
               cost: Optional[Array] = None, mem: Optional[Array] = None,
               freq: Optional[Array] = None) -> None:
        """Merge one batch. ``weight`` drives head membership (the balance
        weight — cost); the side channels ride along for tracked entries.

        Zero-weight keys never *insert* (a quiet held key's state size
        should not evict a genuine heavy hitter) but still accumulate into
        the side counters of already-tracked entries — the engine folds
        end-of-interval state sizes as a zero-cost batch.
        """
        keys = np.asarray(keys, dtype=np.int64)
        if not keys.size:
            return
        weight = np.asarray(weight, dtype=np.float64)
        if keys.size == 1 or bool(np.all(keys[1:] > keys[:-1])):
            # pre-aggregated sorted-unique batch (the controller's observe
            # path and the engine's per-interval folds): skip the O(K log K)
            # unique — the whole update is then O(K)
            uk, w = keys, weight
            sides = {ch: (np.asarray(arr, np.float64)
                          if arr is not None else None)
                     for ch, arr in (("cost", cost), ("mem", mem),
                                     ("freq", freq))}
        else:
            uk, inv = np.unique(keys, return_inverse=True)
            w = np.bincount(inv, weights=weight, minlength=uk.size)
            sides = {}
            for ch, arr in (("cost", cost), ("mem", mem), ("freq", freq)):
                sides[ch] = (np.bincount(inv,
                                         weights=np.asarray(arr, np.float64),
                                         minlength=uk.size)
                             if arr is not None else None)
        self.total += float(w.sum())

        if self._keys.size:
            pos = np.clip(np.searchsorted(self._keys, uk), 0,
                          self._keys.size - 1)
            hit = self._keys[pos] == uk
            hit_at = np.flatnonzero(hit)
        else:
            pos = np.zeros(uk.size, dtype=np.int64)
            hit = np.zeros(uk.size, dtype=bool)
            hit_at = np.zeros(0, dtype=np.int64)

        # hits are bounded by capacity: gather via index lists, not masks
        hidx = pos[hit_at]
        self._count[hidx] += w[hit_at]
        for ch, agg in sides.items():
            if agg is not None:
                self._side[ch][hidx] += agg[hit_at]

        fresh_at = np.flatnonzero(~hit & (w > 0.0))
        if not fresh_at.size:
            return      # tracked set unchanged: still sorted, still <= cap
        m = self._keys.size
        nc = np.concatenate([self._count, w[fresh_at]])
        n = nc.size
        if n > self.capacity:
            # subtract the (capacity+1)-th largest counter from everything;
            # at most `capacity` counters exceed it. Selecting the
            # threshold first (np.partition on the counters alone) keeps a
            # K-sized insert batch O(K): keys/err/side arrays are only
            # materialized for the <= capacity survivors, and only those
            # get sorted.
            t = float(np.partition(nc, n - self.capacity - 1)
                      [n - self.capacity - 1])
            keep = nc > t
            keep_old, keep_new = keep[:m], keep[m:]
            fresh_at = fresh_at[keep_new]
            nk = np.concatenate([self._keys[keep_old], uk[fresh_at]])
            nc = nc[keep] - t
            ne = np.concatenate([self._err[keep_old],
                                 np.full(fresh_at.size, self.offset)])
            ns = {ch: np.concatenate(
                     [self._side[ch][keep_old],
                      agg[fresh_at] if agg is not None
                      else np.zeros(fresh_at.size)])
                  for ch, agg in sides.items()}
            self.offset += t
        else:
            nk = np.concatenate([self._keys, uk[fresh_at]])
            ne = np.concatenate([self._err,
                                 np.full(fresh_at.size, self.offset)])
            ns = {ch: np.concatenate(
                     [self._side[ch],
                      agg[fresh_at] if agg is not None
                      else np.zeros(fresh_at.size)])
                  for ch, agg in sides.items()}
        order = np.argsort(nk, kind="stable")
        self._keys = nk[order]
        self._count = nc[order]
        self._err = ne[order]
        for ch, a in ns.items():
            self._side[ch] = a[order]


class SketchStats:
    """Streaming step-1 measurement with O(H + sketch + n_dest) memory.

    One instance per controller interval cycle: ``update()`` per batch,
    ``snapshot(assignment)`` at the interval boundary, ``end_interval()``
    to reset for the next interval (stats are per-interval quantities,
    matching exact :class:`KeyStats` semantics).

    The per-destination cost totals are accumulated *exactly* (one bincount
    per batch), so ``theta_for`` on the snapshot is exact up to clipping:
    snapshot head loads + ``base_loads`` reproduce the true per-destination
    totals because the head's estimation error cancels in the subtraction
    (``base = total(d) - head(d)``, clipped at zero when a count-min
    overestimate for an untracked table key exceeds its destination total).
    """

    def __init__(self, config: SketchConfig, n_dest: int, seed: int = 0):
        self.config = config
        self.cms = CountMinSketch(config.width, config.depth, seed=seed,
                                  channels=config.channels)
        self.tracker = SpaceSavingTracker(config.capacity)
        self._dest_cost = np.zeros(int(n_dest), dtype=np.float64)
        self._mem_total = 0.0

    def _fold_dest(self, arr: Array, dests: Array, w: Array) -> Array:
        size = max(arr.size, int(dests.max()) + 1)
        out = np.bincount(dests, weights=w, minlength=size)
        out[:arr.size] += arr
        return out

    def update(self, keys: Array, dests: Optional[Array], cost: Array,
               mem: Optional[Array] = None,
               freq: Optional[Array] = None) -> None:
        """Fold one pre-aggregated batch (duplicate keys across batches are
        fine — everything accumulates).

        ``dests`` may be None for an all-zero-cost batch (the engine's
        end-of-interval state-size fold): zero weights contribute nothing
        to the per-destination totals or the count-min planes, so both the
        destination resolve and the sketch fold are skipped.
        """
        keys = np.asarray(keys, dtype=np.int64)
        if not keys.size:
            return
        cost = np.asarray(cost, dtype=np.float64)
        live = bool(cost.any())
        if dests is None:
            if live:
                raise ValueError(
                    "dests is required for a batch with nonzero cost")
        else:
            dests = np.asarray(dests, dtype=np.int64)
            self._dest_cost = self._fold_dest(self._dest_cost, dests, cost)
        if mem is not None:
            self._mem_total += float(np.sum(mem))
        folds = {"cost": cost if live else None, "mem": mem, "freq": freq}
        fold = {ch: folds[ch] for ch in self.cms.planes}
        if any(v is not None for v in fold.values()):
            self.cms.update(keys, **fold)
        self.tracker.update(keys, cost, cost=cost, mem=mem, freq=freq)

    def head_keys(self, assignment: Assignment) -> Array:
        """Tracked heavy hitters ∪ current table keys, sorted."""
        head = self.tracker.keys
        if assignment.table:
            tkeys = np.fromiter(assignment.table.keys(), dtype=np.int64,
                                count=len(assignment.table))
            head = np.union1d(head, tkeys)
        return head

    def snapshot(self, assignment: Assignment) -> KeyStats:
        """Materialize the head-only :class:`KeyStats` (+ tail base loads)."""
        keys = self.head_keys(assignment)
        n_dest = assignment.n_dest
        cost = np.zeros(keys.size)
        mem = np.zeros(keys.size)
        freq = np.zeros(keys.size)
        tracked = np.zeros(keys.size, dtype=bool)
        tk = self.tracker.keys
        if tk.size and keys.size:
            pos = np.clip(np.searchsorted(tk, keys), 0, tk.size - 1)
            tracked = tk[pos] == keys
            tidx = pos[tracked]
            cost[tracked] = self.tracker.side("cost")[tidx]
            mem[tracked] = self.tracker.side("mem")[tidx]
            freq[tracked] = self.tracker.side("freq")[tidx]
        loose = ~tracked
        if loose.any():
            lk = keys[loose]
            # untracked keys are provably light (true weight <= offset by
            # the Misra-Gries invariant), so the count-min refinement is
            # capped there — collision noise never inflates a loose key
            # past the tracker's own bound
            lcost = self.cms.query(lk, "cost")
            lcost = np.minimum(lcost, self.tracker.offset)
            cost[loose] = lcost
            if "mem" in self.cms.planes:
                mem[loose] = self.cms.query(lk, "mem")
            else:
                # cost-proportional proxy from the exact totals; loose keys
                # carry a vanishing mass fraction, so only the order of
                # magnitude matters to the planners' migration accounting
                total = self.tracker.total
                ratio = (self._mem_total / total) if total > 0 else 0.0
                mem[loose] = lcost * ratio
            if "freq" in self.cms.planes:
                freq[loose] = self.cms.query(lk, "freq")
            else:
                freq[loose] = lcost

        dest_cost = self._sized(self._dest_cost, n_dest)
        if keys.size:
            head_per_dest = np.bincount(assignment.dest(keys), weights=cost,
                                        minlength=n_dest)[:n_dest]
            base = np.maximum(dest_cost - head_per_dest, 0.0)
        else:
            base = dest_cost
        return KeyStats(keys=keys, cost=cost, mem=mem, freq=freq,
                        base_loads=base)

    @staticmethod
    def _sized(arr: Array, n_dest: int) -> Array:
        """Pad (grow) or truncate (stale rescale snapshot; the next interval's
        ingest re-derives totals under the new fleet) to ``n_dest``."""
        if arr.size < n_dest:
            return np.concatenate([arr, np.zeros(n_dest - arr.size)])
        return arr[:n_dest].copy()

    def end_interval(self) -> None:
        self.cms.reset()
        self.tracker = SpaceSavingTracker(self.config.capacity)
        self._dest_cost[:] = 0.0
        self._mem_total = 0.0

    # -- serialize seam (checkpointed recovery) --------------------------------
    def state_dict(self) -> dict:
        """Snapshot of the full mid-interval measurement state: recovery
        restores at an interval boundary, but a crash can land after a
        partial ingest, so the planes/tracker/totals must round-trip too."""
        return {"dest_cost": self._dest_cost.copy(),
                "mem_total": self._mem_total,
                "cms": self.cms.state_dict(),
                "tracker": self.tracker.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self._dest_cost = np.asarray(state["dest_cost"],
                                     dtype=np.float64).copy()
        self._mem_total = float(state["mem_total"])
        self.cms.load_state_dict(state["cms"])
        # end_interval swaps the tracker instance, so rebuild before loading
        self.tracker = SpaceSavingTracker(int(state["tracker"]["capacity"]))
        self.tracker.load_state_dict(state["tracker"])

    @property
    def nbytes(self) -> int:
        """Resident controller-side stats memory — O(H + sketch), not O(K)."""
        return int(self.cms.nbytes + self.tracker.nbytes
                   + self._dest_cost.nbytes)
