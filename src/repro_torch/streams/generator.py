"""Synthetic workload generator (paper Sec. V, Table II).

Creates per-interval KeyStats snapshots from an integer key domain of size K:
tuple frequencies follow Zipf(z); parameter ``f`` controls the fluctuation
rate across intervals — at each new interval frequencies are swapped between
keys routed to different task instances until the per-instance workload change
reaches ``|L_i(d) - L_{i-1}(d)| / L_{i-1}(d) >= f`` (the paper's rule).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.balancer import Assignment, KeyStats


def zipf_frequencies(k: int, z: float, total: float = 1e6,
                     rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Frequencies proportional to rank^-z, scaled to ``total`` tuples,
    randomly permuted over key ids (rank != key id)."""
    rng = rng or np.random.default_rng(0)
    ranks = np.arange(1, k + 1, dtype=np.float64)
    p = ranks ** (-z) if z > 0 else np.ones_like(ranks)
    p /= p.sum()
    freq = p * total
    rng.shuffle(freq)
    return freq


@dataclasses.dataclass
class WorkloadGen:
    """Streaming generator of per-interval KeyStats."""

    k: int = 10_000                  # key domain size
    z: float = 0.85                  # zipf skewness
    f: float = 1.0                   # fluctuation rate
    total_tuples: float = 1e6
    cost_per_tuple: float = 1.0
    mem_per_tuple: float = 1.0
    window: int = 1                  # w: S(k,w) sums the last w intervals
    seed: int = 0

    def __post_init__(self) -> None:
        self.rng = np.random.default_rng(self.seed)
        self.keys = np.arange(self.k, dtype=np.int64)
        self.freq = zipf_frequencies(self.k, self.z, self.total_tuples, self.rng)
        self._mem_hist = [self.freq * self.mem_per_tuple]

    def _fluctuate(self, assignment: Assignment) -> None:
        """Swap frequencies between keys on different instances until the
        workload change on some instance reaches f (paper's procedure)."""
        if self.f <= 0:
            return
        dests = assignment.dest(self.keys)
        n_dest = assignment.n_dest
        old_loads = np.bincount(dests, weights=self.freq * self.cost_per_tuple,
                                minlength=n_dest)
        old_loads = np.maximum(old_loads, 1e-9)
        # incremental load maintenance: each swap moves freq mass between two
        # instances, so the per-instance loads update in O(N_D) instead of a
        # full O(K) bincount per candidate swap (same rng draws, same
        # termination rule as the paper's procedure)
        cur_loads = old_loads.copy()
        for _ in range(200_000):
            i, j = self.rng.integers(0, self.k, size=2)
            di, dj = dests[i], dests[j]
            if di == dj or i == j:
                continue
            delta = (self.freq[j] - self.freq[i]) * self.cost_per_tuple
            self.freq[i], self.freq[j] = self.freq[j], self.freq[i]
            cur_loads[di] += delta
            cur_loads[dj] -= delta
            rel = np.abs(cur_loads - old_loads) / old_loads
            if float(np.max(rel)) >= self.f:
                return

    def interval(self, assignment: Assignment, fluctuate: bool = True) -> KeyStats:
        """Produce the next interval's statistics."""
        if fluctuate:
            self._fluctuate(assignment)
        mem_now = self.freq * self.mem_per_tuple
        self._mem_hist.append(mem_now.copy())
        if len(self._mem_hist) > self.window:
            self._mem_hist = self._mem_hist[-self.window:]
        s_kw = np.sum(self._mem_hist, axis=0)
        return KeyStats(keys=self.keys.copy(),
                        cost=self.freq * self.cost_per_tuple,
                        mem=s_kw,
                        freq=self.freq.copy())

    def draw_tuples(self, n: int) -> np.ndarray:
        """Sample n concrete tuple keys from the current distribution."""
        p = self.freq / self.freq.sum()
        return self.rng.choice(self.keys, size=n, p=p)
