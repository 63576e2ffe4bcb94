"""MinTable (paper Alg. 2): erase the whole routing table, psi = highest c(k)."""

from __future__ import annotations

import time

from .llfd import PlannerContext
from .phased import finish, run_phases, table_key_indices
from .types import Assignment, BalanceConfig, KeyStats, RebalanceResult


def mintable(stats: KeyStats, assignment: Assignment,
             config: BalanceConfig) -> RebalanceResult:
    t0 = time.perf_counter()
    ctx = PlannerContext(stats, assignment, config, psi=stats.cost)
    clean = table_key_indices(stats, assignment)     # Phase I: move back ALL of A
    ws = run_phases(stats, assignment, config, clean_idxs=clean, ctx=ctx)
    return finish(ws, assignment, config, t0, cleaned=float(len(clean)))
