"""Balance / migration metrics (paper Sec. II-A and Sec. V 'Evaluation Metrics')."""

from __future__ import annotations

from typing import Optional

import numpy as np

from .types import Assignment, KeyStats


def segment_sum(values: np.ndarray, segment_ids: np.ndarray,
                n_segments: int) -> np.ndarray:
    """Sum ``values`` into ``n_segments`` buckets keyed by ``segment_ids``.

    The host-side twin of the device segment-sums (``kernels.key_stats``):
    the vectorized engine and the load computation below both reduce
    per-key quantities to per-task aggregates through this one primitive.
    """
    return np.bincount(segment_ids, weights=values,
                       minlength=n_segments).astype(np.float64)


def base_for(stats: KeyStats, n_dest: int) -> Optional[np.ndarray]:
    """The stats' frozen tail base loads sized to ``n_dest`` (or None).

    Sketch-mode stats (``balancer/sketch.py``) carry per-destination cost
    for tail keys absent from the per-key arrays. A rescale can briefly
    hand an ``n_dest`` differing from the snapshot's: pad with zeros on
    grow; truncate on shrink (the next interval's ingest re-derives the
    totals under the new fleet).
    """
    base = stats.base_loads
    if base is None:
        return None
    if base.size < n_dest:
        return np.concatenate([base, np.zeros(n_dest - base.size)])
    if base.size > n_dest:
        return base[:n_dest]
    return base


def loads_for(stats: KeyStats, dests: np.ndarray, n_dest: int) -> np.ndarray:
    """L(d) = sum of c(k) over keys assigned to d (+ frozen tail base)."""
    out = segment_sum(stats.cost, dests, n_dest)
    base = base_for(stats, n_dest)
    if base is not None:
        out = out + base
    return out


def loads(stats: KeyStats, assignment: Assignment) -> np.ndarray:
    return loads_for(stats, assignment.dest(stats.keys), assignment.n_dest)


def theta(loads_arr: np.ndarray) -> float:
    """max_d (L(d) - mean) / mean — the one-sided overload indicator.

    This is the form the paper's analysis actually uses (Lemma 3 defines
    theta_max = max_d (L(d) - L_bar)/L_bar) and the constraint every
    algorithm enforces (L(d) <= L_max). The two-sided variant is
    :func:`theta_two_sided`.
    """
    mean = float(np.mean(loads_arr))
    if mean <= 0.0:
        return 0.0
    return max(0.0, float(np.max(loads_arr - mean) / mean))


def theta_for(stats: KeyStats, assignment: Assignment) -> float:
    """theta of the current assignment in one call (trigger-path shorthand).

    The controller's step-2 decision spells
    ``theta(loads(stats, assignment))``; this keeps the pair fused so the
    destination lookup happens exactly once.
    """
    return theta(loads(stats, assignment))


def theta_two_sided(loads_arr: np.ndarray) -> float:
    """max_d |L(d) - mean| / mean (paper Sec. II-A's display form)."""
    mean = float(np.mean(loads_arr))
    if mean <= 0.0:
        return 0.0
    return float(np.max(np.abs(loads_arr - mean)) / mean)


def skewness(loads_arr: np.ndarray) -> float:
    """max L(d) / mean L  (the 'workload skewness' metric of Sec. V)."""
    mean = float(np.mean(loads_arr))
    if mean <= 0.0:
        return 1.0
    return float(np.max(loads_arr) / mean)


def migration_cost(stats: KeyStats, old: Assignment, new: Assignment) -> float:
    """M_i(w, F, F') = sum of S(k, w) over Delta(F, F') (Eq. 2)."""
    moved = old.dest(stats.keys) != new.dest(stats.keys)
    return float(np.sum(stats.mem[moved]))


def moved_keys(stats: KeyStats, old: Assignment, new: Assignment) -> np.ndarray:
    moved = old.dest(stats.keys) != new.dest(stats.keys)
    return stats.keys[moved]


def migration_fraction(stats: KeyStats, old: Assignment,
                       new: Assignment) -> float:
    """Migration cost as a fraction of total maintained state (paper's
    metric)."""
    total = float(np.sum(stats.mem))
    if total <= 0.0:
        return 0.0
    return migration_cost(stats, old, new) / total
