"""The benchmark's traffic: the paper's workload generator (Sec. V, Table
II), read from a traffic mix's parameters and a configuration's key domain
and tuples per interval.

Key frequencies follow Zipf(z) over the key domain, their ranks randomly
permuted over the key ids. Before each interval after the first, the
fluctuation procedure swaps the frequencies of random pairs of keys that sit
on different tasks until some task's load has changed by ``fluctuation``
(relative to the last interval) or :data:`MAX_SWAPS` pairs are drawn. The tasks
are the hash-only placement, which this module works out itself with the
reference's hash, never the program's routing. Each interval then draws the
configuration's ``tuples_per_interval`` tuples from its frequencies: the
count of each key by one multinomial draw, the tuples in a random order
(one permutation of the positions, drawn once, serves every interval).

A mix is a cycle of ``cycle_intervals`` such intervals, drawn before the
measured window and handed to the stage forth and back (0, 1, .., n-1,
n-2, .., 1, 0, ..), so each hand-off moves the frequencies by one
fluctuation, also where the cycle turns: the generator's time never enters
the stage's.

The cycle's counts follow :data:`TRAJECTORY_SEED` and the mix, and the run's
seed orders the tuples of each interval. So the seed changes the tuples'
order and not the work the window asks for: the controller's trigger sits
near theta_max under drift, and intervals that differ by a draw would plan
on different intervals of the window. The intervals that follow the window
for the comparison alone (:meth:`Traffic.checks`) continue the trajectory
from the cycle's last drawn frequencies with fluctuations and draws of the
run's seed, so each seed is judged on counts of its own.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .reference import hash_dest

#: the keys a traffic mix file may hold, with their defaults
MIX_DEFAULTS = {"z": 0.0, "fluctuation": 0.0, "cycle_intervals": 8}
#: the fluctuation procedure's cap on the pairs it draws an interval, as
#: the repo's generators cap it (at K = 10^6 the cap, not f, ends it)
MAX_SWAPS = 200_000
#: the seed of every mix's frequencies and draws
TRAJECTORY_SEED = 0


def mix_params(mix: dict) -> dict:
    unknown = set(mix) - set(MIX_DEFAULTS) - {"why"}
    if unknown:
        raise ValueError(f"unknown traffic keys {sorted(unknown)}")
    return {**MIX_DEFAULTS, **mix}


def rng_for(seed: int, stream: int = 0) -> np.random.Generator:
    """The generator of a run's draws: any whole seed, negative too;
    ``stream`` picks one of its independent streams."""
    seed = int(seed) % (1 << 64)
    return np.random.default_rng([seed, stream] if stream else seed)


def zipf_frequencies(k: int, z: float, rng: np.random.Generator
                     ) -> np.ndarray:
    """Probabilities proportional to rank^-z, permuted over the key ids."""
    ranks = np.arange(1, k + 1, dtype=np.float64)
    p = ranks ** (-z) if z > 0 else np.ones_like(ranks)
    p /= p.sum()
    rng.shuffle(p)
    return p


#: candidate pairs scanned at once for a run of pairs that share no key
_BLOCK = 4096


def fluctuate(freq: np.ndarray, placement: np.ndarray, n_tasks: int, f: float,
              max_swaps: int, rng: np.random.Generator) -> int:
    """Swap frequencies of random key pairs on different tasks, in place,
    one pair after another, until a task's load has moved by ``f`` of its
    last value or ``max_swaps`` pairs are drawn; returns the swaps made.

    Pairs on one task are skipped. Swaps that share no key commute, so each
    run of pairs up to the first key seen twice is applied at once, and the
    loads after each of its swaps are running sums."""
    if f <= 0 or max_swaps <= 0:
        return 0
    old = np.maximum(np.bincount(placement, weights=freq,
                                 minlength=n_tasks), 1e-12)
    cur = old.copy()
    pairs = rng.integers(0, freq.size, size=(max_swaps, 2))
    pairs = pairs[placement[pairs[:, 0]] != placement[pairs[:, 1]]]
    swaps = start = 0
    size = 64
    while start < len(pairs):
        block = pairs[start:start + size]
        flat = block.ravel()
        _, first = np.unique(flat, return_index=True)
        again = np.ones(flat.size, dtype=bool)
        again[first] = False
        n = int(np.argmax(again)) // 2 if again.any() else len(block)
        size = min(_BLOCK, 2 * n + 64)
        i, j = block[:n, 0], block[:n, 1]
        delta = freq[j] - freq[i]
        step = np.zeros((n, n_tasks))
        rows = np.arange(n)
        step[rows, placement[i]] += delta
        step[rows, placement[j]] -= delta
        loads = cur + np.cumsum(step, axis=0)
        reached = (np.abs(loads - old) >= f * old).any(axis=1)
        done = bool(reached.any())
        if done:
            n = int(np.argmax(reached)) + 1
            i, j = i[:n], j[:n]
        fi = freq[i]
        freq[i] = freq[j]
        freq[j] = fi
        cur = loads[n - 1]
        swaps += n
        if done:
            break
        start += n
    return swaps


def forth_and_back(n: int) -> List[int]:
    """The order a cycle of ``n`` intervals is handed in, one period."""
    return list(range(n)) + list(range(n - 2, 0, -1))


class Traffic:
    """A mix's intervals for one run: ``interval(i)`` is the ``i``-th
    handed to the stage (warm-up and window); ``checks(n)`` the ``n`` that
    follow the window for the comparison alone."""

    def __init__(self, mix: dict, keys: int, tasks: int, hash_seed: int,
                 tuples: int, seed: int):
        p = mix_params(mix)
        self.keys, self.tasks, self.tuples = int(keys), int(tasks), int(tuples)
        self.f = float(p["fluctuation"])
        rng = rng_for(TRAJECTORY_SEED)
        freq = zipf_frequencies(self.keys, float(p["z"]), rng)
        self.placement = hash_dest(np.arange(self.keys, dtype=np.int64),
                                   self.tasks, hash_seed)
        self.order = rng_for(seed).permutation(self.tuples)
        self.cycle = []
        for i in range(int(p["cycle_intervals"])):
            if i:
                fluctuate(freq, self.placement, self.tasks, self.f,
                          MAX_SWAPS, rng)
            self.cycle.append(self._draw(freq, rng))
        self.turn = forth_and_back(len(self.cycle))
        self._freq, self._seed = freq, seed

    def _draw(self, freq: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        counts = rng.multinomial(self.tuples, freq / freq.sum())
        ids = np.arange(self.keys, dtype=np.int64)
        return np.repeat(ids, counts)[self.order]

    def interval(self, i: int) -> np.ndarray:
        return self.cycle[self.turn[i % len(self.turn)]]

    def checks(self, n: int) -> List[np.ndarray]:
        rng = rng_for(self._seed, stream=1)
        freq = self._freq.copy()
        out = []
        for _ in range(n):
            fluctuate(freq, self.placement, self.tasks, self.f, MAX_SWAPS,
                      rng)
            out.append(self._draw(freq, rng))
        return out
