"""Plain NumPy reference of the keyed stream stage the benchmark judges.

It imports NumPy and the standard library only: nothing of the program
under test. It holds its own copy of the router's hash (murmur3's 32-bit
finalizer, then mod N_D), works out F(k) from a routing table the program
published, and replays a windowed operator over the same intervals of keys
the program was handed, from empty state. The operator's own semantics
(cost, output and emits of the keys an interval sees, the bytes a key holds)
sit in ``bench/operators/<operator>.py``, found by the configuration's
``operator`` name, so an operator is added by a file alone.

The window: after interval ``t`` a key holds the slots of intervals
``t - window + 1 .. t``; the tuples of interval ``t`` see those of
``t - window .. t - 1`` held before it arrives.

Between two intervals the state of every held key whose F changed moves to
its new task; the bytes moved are the sum of those keys' state sizes.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from types import ModuleType
from typing import Dict, Optional

import numpy as np

_M32 = 0xFFFFFFFF
BENCH = Path(__file__).resolve().parent


def load_operator(name: str, bench: Path = BENCH) -> ModuleType:
    """The operator's semantics, ``<bench>/operators/<name>.py``."""
    path = bench / "operators" / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"unknown operator {name!r}: no {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_operator_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def fmix32(x: np.ndarray, seed: int = 0) -> np.ndarray:
    """murmur3's 32-bit finalizer of ``x ^ seed``, uint32 lanes."""
    h = np.asarray(x).astype(np.uint32) ^ np.uint32(seed & _M32)
    with np.errstate(over="ignore"):
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
    return h


def hash_dest(keys: np.ndarray, n_dest: int, seed: int = 0) -> np.ndarray:
    """The hash-only placement h(k) = fmix32(k ^ seed) mod N_D, int64."""
    return (fmix32(keys, seed) % np.uint32(n_dest)).astype(np.int64)


def dest_table(base: np.ndarray, table: Dict[int, int]) -> np.ndarray:
    """F(k) over every key id: the table's dest where it holds the key,
    else the hash placement ``base``. Table keys outside the domain route
    no key."""
    out = base.copy()
    if table:
        tk = np.fromiter(table.keys(), dtype=np.int64, count=len(table))
        td = np.fromiter(table.values(), dtype=np.int64, count=len(table))
        inside = (tk >= 0) & (tk < base.size)
        out[tk[inside]] = td[inside]
    return out


def theta(loads: np.ndarray) -> float:
    """max_d (L(d) - mean) / mean, one-sided (the paper's trigger)."""
    mean = float(np.mean(loads))
    if mean <= 0.0:
        return 0.0
    return max(0.0, float(np.max(loads - mean) / mean))


class ReferenceStage:
    """The stage's semantics over a dense key domain ``[0, keys)``.

    ``step(keys, table)`` runs one interval under the routing table in
    force for it and returns the per-task loads and the bytes moved when
    that table replaced the previous one.
    """

    def __init__(self, operator: str, keys: int, tasks: int, window: int,
                 hash_seed: int = 0, bench: Path = BENCH, **args):
        self.op = load_operator(operator, bench)
        self.args = {**self.op.DEFAULTS, **args}
        self.operator = operator
        self.k = int(keys)
        self.tasks = int(tasks)
        self.window = int(window)
        self.base = hash_dest(np.arange(self.k, dtype=np.int64), self.tasks,
                              hash_seed)
        self.interval = 0
        self.slots: Dict[int, np.ndarray] = {}   # interval -> counts (K,)
        self.output = np.zeros(self.k, dtype=np.int64)
        self.has_output = np.zeros(self.k, dtype=bool)
        self.emitted = 0.0
        self.mem = np.zeros(self.k, dtype=np.float64)
        self.held = np.zeros(self.k, dtype=bool)
        self.dest: Optional[np.ndarray] = None   # F in force last interval
        self.cost = np.zeros(self.k, dtype=np.float64)  # last interval's
        self.counts = np.zeros(self.k, dtype=np.int64)  # last interval's

    def route(self, table: Dict[int, int]) -> np.ndarray:
        return dest_table(self.base, table)

    def migrated_bytes(self, new_dest: np.ndarray) -> float:
        """Bytes of the held keys whose F changes from the last interval's."""
        if self.dest is None:
            return 0.0
        moved = self.held & (self.dest != new_dest)
        return float(self.mem[moved].sum())

    def step(self, keys: np.ndarray, table: Dict[int, int],
             dest: Optional[np.ndarray] = None):
        """One interval. Returns ``(loads, migrated_bytes, dest)``."""
        self.interval += 1
        t = self.interval
        dest = self.route(table) if dest is None else dest
        moved_bytes = self.migrated_bytes(dest)
        counts = np.bincount(np.asarray(keys, dtype=np.int64),
                             minlength=self.k).astype(np.int64)
        if counts.size != self.k:
            raise ValueError("a key id lies outside the key domain")
        win0 = np.zeros(self.k, dtype=np.int64)
        for c in self.slots.values():
            win0 += c
        seen = counts > 0
        m, c0 = counts[seen], win0[seen]
        cost, out, emitted = self.op.interval(m, c0, self.args)
        self.cost = np.zeros(self.k, dtype=np.float64)
        self.cost[seen] = cost
        loads = np.bincount(dest[seen], weights=cost, minlength=self.tasks)
        self.output[seen] = out
        self.emitted += emitted
        self.has_output |= seen
        self.counts = counts
        self.slots[t] = counts
        for old in [i for i in self.slots if i < t - self.window + 1]:
            del self.slots[old]
        n_slots = np.zeros(self.k, dtype=np.int64)
        held_sum = np.zeros(self.k, dtype=np.int64)
        for c in self.slots.values():
            n_slots += c > 0
            held_sum += c
        self.held = n_slots > 0
        self.mem = self.op.memory(n_slots, held_sum, self.args)
        self.dest = dest
        return loads, moved_bytes, dest

    def ring(self, columns: int):
        """The window as a ring of ``columns`` slots, interval ``i`` in
        column ``i % columns``: ``(counts, present)``, each
        ``(columns, K)``; columns that hold no interval are zero."""
        vals = np.zeros((columns, self.k), dtype=np.int64)
        for i, c in self.slots.items():
            vals[i % columns] = c
        return vals, (vals > 0).astype(np.int64)
