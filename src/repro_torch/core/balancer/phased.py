"""Result assembly shared by the phase-based planners (paper Sec. III).

Each phase-based algorithm is a Phase-I cleaning policy + psi criterion
feeding the same LLFD Phase III (:mod:`.llfd`); this module turns a drained
workspace into a :class:`RebalanceResult` and finds the current table keys.
"""

from __future__ import annotations

import time

import numpy as np

from . import metrics
from .types import Assignment, BalanceConfig, KeyStats, RebalanceResult


def finish(ws, assignment: Assignment, config: BalanceConfig,
           t0: float, **meta: float) -> RebalanceResult:
    """Assemble a :class:`RebalanceResult` from a drained workspace.

    Loads are recomputed canonically (one segment-sum over the final
    assignment) rather than read from the workspace's incrementally
    maintained estimate, so reported loads/theta do not depend on the
    internal float accumulation order.
    """
    table = ws.result_table()
    new = Assignment(assignment.hash_router, table)
    moved = ws.moved_mask()
    loads = metrics.loads_for(ws.stats, ws.assign, ws.n_dest)
    th = metrics.theta(loads)
    return RebalanceResult(
        assignment=new,
        moved_keys=ws.stats.keys[moved],
        migration_cost=float(np.sum(ws.mem[moved])),
        loads=loads,
        table_size=len(table),
        theta=th,
        feasible_balance=th <= config.theta_max + 1e-9,
        feasible_table=len(table) <= config.table_max,
        plan_time_s=time.perf_counter() - t0,
        meta=dict(meta),
    )


def table_key_indices(stats: KeyStats, assignment: Assignment) -> np.ndarray:
    """Indices (into stats arrays) of keys that currently sit in the table A.

    Sorted-table binary search — O(K log A) instead of ``np.isin``'s
    O((K+A) log (K+A)) — computed once per planner call.
    """
    if not assignment.table:
        return np.zeros((0,), dtype=np.int64)
    tkeys = np.fromiter(assignment.table.keys(), dtype=np.int64,
                        count=len(assignment.table))
    tkeys.sort()
    pos = np.clip(np.searchsorted(tkeys, stats.keys), 0, len(tkeys) - 1)
    return np.flatnonzero(tkeys[pos] == stats.keys)
