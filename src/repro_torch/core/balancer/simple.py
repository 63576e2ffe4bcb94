"""The Simple algorithm (paper Alg. 5, appendix) — FFD-style full reassignment.

Used for the Theorem-1 analysis: if a perfect assignment exists and
c(k_1) < mean load, the resulting imbalance is <= 1/3 * (1 - 1/N_D).
"""

from __future__ import annotations

import time

import numpy as np

from . import metrics
from .types import Assignment, BalanceConfig, KeyStats, RebalanceResult


def simple(stats: KeyStats, assignment: Assignment,
           config: BalanceConfig) -> RebalanceResult:
    t0 = time.perf_counter()
    n_dest = assignment.n_dest
    hash_dest = assignment.hash_router(stats.keys)
    order = np.argsort(-stats.cost, kind="stable")
    loads = np.zeros((n_dest,), dtype=np.float64)
    assign = np.zeros((stats.num_keys,), dtype=np.int64)
    for idx in order:
        d = int(np.argmin(loads))
        assign[idx] = d
        loads[d] += stats.cost[idx]
    table = {int(k): int(d) for k, d, h in zip(stats.keys, assign, hash_dest)
             if d != h}
    new = Assignment(assignment.hash_router, table)
    moved = assign != assignment.dest(stats.keys)
    return RebalanceResult(
        assignment=new,
        moved_keys=stats.keys[moved],
        migration_cost=float(np.sum(stats.mem[moved])),
        loads=loads,
        table_size=len(table),
        theta=metrics.theta(loads),
        feasible_balance=metrics.theta(loads) <= config.theta_max + 1e-9,
        feasible_table=len(table) <= config.table_max,
        plan_time_s=time.perf_counter() - t0,
    )
