"""Core datatypes for the skew-shield balancer (paper Sec. II).

Everything here is *control plane*: plain numpy / python, runs on the host
controller. The data plane (vectorized routing of millions of tuples) lives in
``repro_torch.kernels``.

Key universe convention: algorithms operate on *key indices* ``0..K-1`` into
the per-interval :class:`KeyStats` arrays; the actual 64-bit key ids are kept
alongside so routing tables can be materialized for the data plane.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np

Array = np.ndarray


@dataclasses.dataclass
class KeyStats:
    """Per-key statistics measured over one time interval ``T_{i-1}``.

    Mirrors the paper's notation:
      * ``freq[k]``  = g_{i-1}(k)   tuple frequency
      * ``cost[k]``  = c_{i-1}(k)   computation cost (CPU-seconds / chip-FLOPs)
      * ``mem[k]``   = S_{i-1}(k,w) windowed state size (bytes)

    ``base_loads`` (optional, sketch-mode stats — see ``balancer/sketch.py``)
    carries per-destination cost that belongs to *tail* keys not present in
    the per-key arrays: those keys are frozen on their hash destinations
    (the ``head_fraction`` head/tail contract), and every load/theta
    computation folds the base in (``metrics.loads_for``,
    ``PlannerContext.mean_load``). ``None`` (the default) means the per-key
    arrays are the whole universe — exact-mode stats.
    """

    keys: Array                    # (K,) int64 unique key ids
    cost: Array                    # (K,) float64
    mem: Array                     # (K,) float64
    freq: Optional[Array] = None   # (K,) float64, optional
    base_loads: Optional[Array] = None  # (n_dest,) float64, optional

    def __post_init__(self) -> None:
        self.keys = np.asarray(self.keys, dtype=np.int64)
        self.cost = np.asarray(self.cost, dtype=np.float64)
        self.mem = np.asarray(self.mem, dtype=np.float64)
        if self.freq is not None:
            self.freq = np.asarray(self.freq, dtype=np.float64)
        if self.base_loads is not None:
            self.base_loads = np.asarray(self.base_loads, dtype=np.float64)
            if self.base_loads.ndim != 1:
                raise ValueError("base_loads must be a 1-D (n_dest,) array")
        if self.keys.shape != self.cost.shape or self.keys.shape != self.mem.shape:
            raise ValueError("KeyStats arrays must have identical shapes")

    @property
    def num_keys(self) -> int:
        return int(self.keys.shape[0])

    def gamma(self, beta: float) -> Array:
        """Migration priority index gamma_i(k,w) = c(k)^beta / S(k,w) (Sec. III-B).

        For beta > 0 a key of cost <= 0 has gamma +0.0, so the power runs
        only on the other keys (a NaN cost or memory still gives NaN); no
        entry is -0.0.
        """
        if not beta > 0.0:
            mem = np.where(self.mem <= 0.0, 1.0, self.mem)
            return np.power(np.maximum(self.cost, 0.0), beta) / mem
        live = np.flatnonzero(~(self.cost <= 0.0) | np.isnan(self.mem))
        mem = self.mem[live]
        out = np.zeros(self.cost.shape)
        out[live] = (np.power(np.maximum(self.cost[live], 0.0), beta)
                     / np.where(mem <= 0.0, 1.0, mem))
        return out


@dataclasses.dataclass
class BalanceConfig:
    """User-facing knobs, names per the paper's Table II."""

    theta_max: float = 0.08        # tolerance on load imbalance
    table_max: int = 3_000         # A_max: routing table budget
    beta: float = 1.5              # migration selection factor
    window: int = 1                # w: state retention window (intervals)
    discretize_r: Optional[int] = None  # r: HLHE degree (None = raw values)
    # numerical slack for L <= L_max comparisons (theta_max = 0 must work)
    rel_eps: float = 1e-9
    # safety valve for the LLFD exchange cascade (see llfd.py)
    max_llfd_events: int = 1_000_000
    # head/tail split (llfd.py): keys with c(k) >= head_fraction * mean load
    # (plus all current table keys) get exact LLFD/Adjust placement; the tail
    # stays frozen on its hash destinations as pre-aggregated base loads.
    # 0.0 = every key is head (exact planner, pre-split behavior).
    head_fraction: float = 0.0

    def l_max(self, mean_load: float) -> float:
        return (1.0 + self.theta_max) * mean_load * (1.0 + self.rel_eps) + 1e-12


def strictly_ascending(keys: Array) -> bool:
    """Whether each key exceeds the one before; a short prefix is tried
    first, so an unsorted batch costs no whole pass."""
    head = keys[:64]
    return (bool(np.all(head[1:] > head[:-1]))
            and bool(np.all(keys[1:] > keys[:-1])))


def find_sorted(keys: Array, targets: Array) -> tuple[Array, Array]:
    """Where each of ``targets`` sits in the ascending, non-empty ``keys``:
    (positions, clipped to the last, and whether the key there is the
    target)."""
    pos = np.minimum(np.searchsorted(keys, targets), keys.size - 1)
    return pos, keys[pos] == targets


class HashRouter:
    """Vectorized base hash h: K -> D. See hashing.py for implementations."""

    n_dest: int

    def __call__(self, keys: Array) -> Array:  # pragma: no cover - interface
        raise NotImplementedError

    def with_n_dest(self, n_dest: int) -> "HashRouter":  # pragma: no cover
        raise NotImplementedError


@dataclasses.dataclass
class Assignment:
    """The mixed assignment function F(k) = A[k] if k in A else h(k) (Eq. 1)."""

    hash_router: "HashRouter"
    table: Dict[int, int] = dataclasses.field(default_factory=dict)

    @property
    def n_dest(self) -> int:
        return self.hash_router.n_dest

    @property
    def table_size(self) -> int:
        return len(self.table)

    def dest(self, keys: Array, hashed: Optional[Array] = None) -> Array:
        """Vectorized F(k) for an array of key ids.

        ``hashed`` is ``hash_router(keys)`` where the caller has it already.
        Strictly ascending keys (a stats universe) take the table's entries
        written into the hash at their positions, found by searching the
        <= A table keys in the K keys; other keys search the sorted table.
        """
        keys = np.asarray(keys, dtype=np.int64)
        out = self.hash_router(keys) if hashed is None else hashed
        out = out.astype(np.int64)
        if not self.table or not keys.size:
            return out
        tkeys, tdest = self.sorted_table()
        if strictly_ascending(keys):
            pos, hit = find_sorted(keys, tkeys)
            out[pos[hit]] = tdest[hit]
            return out
        pos = np.searchsorted(tkeys, keys)
        pos = np.clip(pos, 0, len(tkeys) - 1)
        hit = tkeys[pos] == keys
        return np.where(hit, tdest[pos], out)

    def sorted_table(self) -> tuple[Array, Array]:
        """The table's (keys, dests), int64, by ascending key."""
        n = len(self.table)
        tkeys = np.fromiter(self.table.keys(), dtype=np.int64, count=n)
        tdest = np.fromiter(self.table.values(), dtype=np.int64, count=n)
        order = np.argsort(tkeys, kind="stable")
        return tkeys[order], tdest[order]

    def dest_one(self, key: int) -> int:
        if key in self.table:
            return self.table[key]
        return int(self.hash_router(np.asarray([key], dtype=np.int64))[0])

    def table_arrays(self, a_max: Optional[int] = None) -> tuple[Array, Array]:
        """(keys, dests) padded to a_max with key=-1 — data-plane handoff format."""
        n = len(self.table)
        a_max = n if a_max is None else a_max
        if n > a_max:
            raise ValueError(f"table size {n} exceeds a_max {a_max}")
        tk = np.full((a_max,), -1, dtype=np.int64)
        td = np.zeros((a_max,), dtype=np.int32)
        if n:
            tk[:n] = np.fromiter(self.table.keys(), dtype=np.int64, count=n)
            td[:n] = np.fromiter(self.table.values(), dtype=np.int32, count=n)
        return tk, td

    def copy(self) -> "Assignment":
        return Assignment(self.hash_router, dict(self.table))


@dataclasses.dataclass
class RebalanceResult:
    """Outcome of one controller decision (one solve of Eq. 3)."""

    assignment: Assignment            # F' (with new table A')
    moved_keys: Array                 # Delta(F, F') as key ids
    migration_cost: float             # M_i(w, F, F') = sum S over Delta
    loads: Array                      # (N_D,) post-rebalance estimated loads
    table_size: int
    theta: float                      # max_d |L(d) - mean| / mean
    feasible_balance: bool            # theta <= theta_max ?
    feasible_table: bool              # |A'| <= A_max ?
    plan_time_s: float = 0.0          # wall time to produce the plan
    meta: Dict[str, float] = dataclasses.field(default_factory=dict)

    def same_plan(self, other: "RebalanceResult") -> bool:
        """Bit-identical plan equality: table, moved keys, loads and theta.

        Holds an array-native plan against the scalar oracle's (timing
        fields and meta are intentionally ignored).
        """
        return (self.assignment.table == other.assignment.table
                and np.array_equal(np.sort(self.moved_keys),
                                   np.sort(other.moved_keys))
                and np.array_equal(self.loads, other.loads)
                and self.theta == other.theta
                and self.table_size == other.table_size)


Algorithm = Callable[[KeyStats, Assignment, BalanceConfig], RebalanceResult]
