"""MinMig (paper Alg. 3): no cleaning, psi = largest gamma(k,w) = c^beta / S first."""

from __future__ import annotations

import time

from .llfd import PlannerContext
from .phased import finish, run_phases
from .types import Assignment, BalanceConfig, KeyStats, RebalanceResult


def minmig(stats: KeyStats, assignment: Assignment,
           config: BalanceConfig) -> RebalanceResult:
    t0 = time.perf_counter()
    ctx = PlannerContext(stats, assignment, config,
                         psi=stats.gamma(config.beta))
    ws = run_phases(stats, assignment, config, clean_idxs=None, ctx=ctx)
    return finish(ws, assignment, config, t0)
