"""PKG baseline (Nasir et al., ICDE'15) — split-key partial key grouping.

Power-of-two-choices: every key has two candidate destinations h1(k), h2(k);
each *tuple* is routed to whichever of the two currently has less load. This
splits a key's tuples across two workers, so stateful key semantics require a
downstream merge operator (paper Fig. 2) — surfaced as ``merge_cost`` so
throughput simulations can charge for it. PKG performs no migration.

These are the sequential greedy oracles; the stage-level router is
:class:`~repro_torch.core.balancer.strategy.PartialKeyGrouping`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .hashing import splitmix64
from .types import KeyStats

_U64 = np.uint64


@dataclasses.dataclass
class PKGResult:
    loads: np.ndarray            # per-dest tuple-weighted load
    split_keys: int              # keys whose tuples landed on both choices
    merge_cost: float            # extra work: one merge per split key per interval


def pkg_route(keys: np.ndarray, weights: np.ndarray, n_dest: int,
              seed: int = 0) -> PKGResult:
    """Greedy per-tuple two-choice routing over a tuple stream.

    ``keys``/``weights`` are per-tuple (a key id repeats g(k) times, or is
    pre-aggregated with weights = per-chunk cost). Sequential by construction
    (each choice depends on current loads), mirroring the real algorithm.
    """
    keys = np.asarray(keys, dtype=np.int64)
    h1 = (splitmix64(keys.view(_U64) ^ _U64(seed)) % _U64(n_dest)).astype(np.int64)
    h2 = (splitmix64(keys.view(_U64) ^ _U64(seed + 0x5BD1E995))
          % _U64(n_dest)).astype(np.int64)
    loads = np.zeros((n_dest,), dtype=np.float64)
    used = {}
    for k, w, a, b in zip(keys, weights, h1, h2):
        d = int(a) if loads[a] <= loads[b] else int(b)
        loads[d] += float(w)
        used.setdefault(int(k), set()).add(d)
    split = sum(1 for s in used.values() if len(s) > 1)
    return PKGResult(loads=loads, split_keys=split, merge_cost=float(split))


def pkg_route_stats(stats: KeyStats, n_dest: int, chunks: int = 8,
                    seed: int = 0) -> PKGResult:
    """Route a KeyStats interval by splitting each key's cost into ``chunks``
    sub-tuples (PKG's granularity advantage comes precisely from splitting)."""
    reps = np.repeat(stats.keys, chunks)
    w = np.repeat(stats.cost / chunks, chunks)
    return pkg_route(reps, w, n_dest, seed=seed)
