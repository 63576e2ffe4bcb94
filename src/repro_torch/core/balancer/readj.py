"""Readj baseline (Gedik, VLDBJ'14 [11]) as characterized by the paper.

"It considers all possible swaps by pairing tasks and keys to find the best
key movement to alleviate the workload imbalance ... just considers adjusting
the big load keys."

Implementation: iterative local search. Only keys whose cost exceeds a
``sigma`` fraction of the mean load participate ("big load keys"). Each round
evaluates every candidate single-key move and every candidate pairwise swap
between instances, applies the one that most reduces max load, and stops when
balanced or no improving move exists. Readj also prefers restoring keys to
their hash destination (to shrink the routing table), which we honour via a
tie-break. Complexity is O(rounds * H^2) for H heavy keys — the quadratic
blow-up the paper's Figs. 8/12 exhibit.
"""

from __future__ import annotations

import time

import numpy as np

from . import metrics
from .types import Assignment, BalanceConfig, KeyStats, RebalanceResult


def readj(stats: KeyStats, assignment: Assignment, config: BalanceConfig,
          sigma: float = 0.01, max_rounds: int = 10_000) -> RebalanceResult:
    t0 = time.perf_counter()
    n_dest = assignment.n_dest
    hash_dest = assignment.hash_router(stats.keys)
    assign = assignment.dest(stats.keys).copy()
    cost = stats.cost
    loads = np.bincount(assign, weights=cost, minlength=n_dest).astype(np.float64)
    base = metrics.base_for(stats, n_dest)   # frozen tail (sketch-mode stats)
    base_sum = 0.0
    if base is not None:
        loads += base
        base_sum = float(base.sum())
    mean = (float(np.sum(cost)) + base_sum) / n_dest
    l_max = config.l_max(mean)

    heavy = np.flatnonzero(cost >= sigma * mean)     # "big load keys" only
    for _ in range(max_rounds):
        if float(np.max(loads)) <= l_max:
            break
        src = int(np.argmax(loads))
        src_keys = heavy[assign[heavy] == src]
        if len(src_keys) == 0:
            break
        best = None  # (new_max_pair, prefer_hash_penalty, kind, i, j, dst)
        # single moves: heavy key i from src -> any other dest
        for i in src_keys:
            for dst in range(n_dest):
                if dst == src:
                    continue
                new_src = loads[src] - cost[i]
                new_dst = loads[dst] + cost[i]
                score = max(new_src, new_dst)
                pen = 0 if hash_dest[i] == dst else 1
                cand = (score, pen, 0, int(i), -1, dst)
                if best is None or cand < best:
                    best = cand
        # pairwise swaps: heavy i on src <-> heavy j elsewhere
        for i in src_keys:
            others = heavy[assign[heavy] != src]
            for j in others:
                dst = int(assign[j])
                if cost[i] <= cost[j]:
                    continue
                new_src = loads[src] - cost[i] + cost[j]
                new_dst = loads[dst] + cost[i] - cost[j]
                score = max(new_src, new_dst)
                pen = (0 if hash_dest[i] == dst else 1) + (0 if hash_dest[j] == src else 1)
                cand = (score, pen, 1, int(i), int(j), dst)
                if best is None or cand < best:
                    best = cand
        if best is None or best[0] >= float(np.max(loads)) - 1e-12:
            break                                     # no improving move
        _, _, kind, i, j, dst = best
        src_d = int(assign[i])
        loads[src_d] -= cost[i]
        loads[dst] += cost[i]
        assign[i] = dst
        if kind == 1:
            loads[dst] -= cost[j]
            loads[src_d] += cost[j]
            assign[j] = src_d

    table = {int(k): int(d) for k, d, h in zip(stats.keys, assign, hash_dest)
             if d != h}
    new = Assignment(assignment.hash_router, table)
    moved = assign != assignment.dest(stats.keys)
    th = metrics.theta(loads)
    return RebalanceResult(
        assignment=new, moved_keys=stats.keys[moved],
        migration_cost=float(np.sum(stats.mem[moved])), loads=loads,
        table_size=len(table), theta=th,
        feasible_balance=th <= config.theta_max + 1e-9,
        feasible_table=len(table) <= config.table_max,
        plan_time_s=time.perf_counter() - t0, meta={"sigma": sigma},
    )


def readj_best_sigma(stats: KeyStats, assignment: Assignment,
                     config: BalanceConfig,
                     sigmas=(0.2, 0.1, 0.05, 0.02, 0.01, 0.005)) -> RebalanceResult:
    """The paper tunes Readj's sigma per experiment and reports the best run."""
    best = None
    for s in sigmas:
        r = readj(stats, assignment, config, sigma=s)
        key = (not r.feasible_balance, r.theta, r.migration_cost)
        if best is None or key < best[0]:
            best = (key, r)
    return best[1]
