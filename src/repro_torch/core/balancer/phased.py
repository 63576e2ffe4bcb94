"""Shared Phase I/II/III runner for MinTable, MinMig and Mixed (paper Sec. III).

Each algorithm is a different Phase-I cleaning policy + psi criterion feeding
the same LLFD Phase III; this module owns the plumbing and result assembly.
Algorithms that run several trials (Mixed's n-escalation) build one
:class:`PlannerContext` and clone checkpoints instead of calling
:func:`run_phases` repeatedly — see ``mixed.py``.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from . import metrics
from .llfd import PlannerContext, Workspace, llfd
from .types import Assignment, BalanceConfig, KeyStats, RebalanceResult


def run_phases(stats: KeyStats, assignment: Assignment, config: BalanceConfig,
               *, psi: Optional[np.ndarray] = None,
               clean_idxs: Optional[np.ndarray] = None,
               ctx: Optional[PlannerContext] = None) -> Workspace:
    """Phase I (move back ``clean_idxs``) -> Phase II -> Phase III (LLFD)."""
    if ctx is None:
        ctx = PlannerContext(stats, assignment, config, psi=psi)
    ws = Workspace(ctx=ctx)
    if clean_idxs is not None:
        ws.move_back_many(np.asarray(clean_idxs, dtype=np.int64))
    ws.prepare()
    llfd(ws)
    return ws


def finish(ws, assignment: Assignment, config: BalanceConfig,
           t0: float, **meta: float) -> RebalanceResult:
    """Assemble a :class:`RebalanceResult` from a drained workspace.

    Loads are recomputed canonically (one segment-sum over the final
    assignment) rather than read from the workspace's incrementally
    maintained estimate, so the array-native planner and the scalar oracle
    (:mod:`.reference`) report bit-identical loads/theta regardless of their
    internal float accumulation order. Works for both workspace
    implementations. ``loads_for`` folds in any frozen tail base loads
    (sketch-mode stats), so the reported loads/theta cover the whole
    stream, not just the head.
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
