"""Mixed (paper Alg. 4) and its brute-force variant Mixed_BF.

Phase I moves back ``n`` table keys chosen by eta = smallest S(k,w) first;
Phases II/III follow MinMig (psi = largest gamma first). ``n`` starts at 0 and
is bumped by the table overuse of the previous trial (paper line 10). The
bump is monotone (n += overuse, capped at N_A) so the loop provably
terminates; at n = N_A the trial equals MinTable, matching the paper's
observation that Mixed degenerates to MinTable when even the minimal table
needed for balance exceeds A_max.

Incremental trial reuse: one :class:`PlannerContext` (hash/current dests, psi
ranks, eta order, table membership) is built per call, and a ``base``
workspace tracks the cumulative Phase-I state — since the cleaned set for
trial n is a *prefix* of the eta order, escalating n only moves back the
newly added keys on the checkpoint, and each trial starts from an O(K)
array-copy clone instead of a full per-key rebuild.
"""

from __future__ import annotations

import time

import numpy as np

from ... import trace
from . import metrics
from .llfd import PlannerContext, Workspace, llfd
from .phased import finish, table_key_indices
from .types import Assignment, BalanceConfig, KeyStats, RebalanceResult


def _eta_order(stats: KeyStats, assignment: Assignment) -> np.ndarray:
    """Table-key indices sorted by smallest memory consumption S(k,w) first."""
    idx = table_key_indices(stats, assignment)
    return idx[np.argsort(stats.mem[idx], kind="stable")]


def _run_trial(base: Workspace) -> Workspace:
    ws = base.clone()
    ws.prepare()
    llfd(ws)
    return ws


def mixed(stats: KeyStats, assignment: Assignment,
          config: BalanceConfig) -> RebalanceResult:
    t0 = time.perf_counter()
    with trace.span("plan.prepare"):
        psi = stats.gamma(config.beta)
        ctx = PlannerContext(stats, assignment, config, psi=psi)
        by_eta = _eta_order(stats, assignment)
        n_a = len(by_eta)
        base = Workspace(ctx=ctx)    # checkpoint: Phase-I state, grown in place
    cleaned = 0
    n = 0
    trials = 0
    while True:
        with trace.span("plan.trial"):
            if n > cleaned:          # Phase I delta: newly cleaned eta prefix
                base.move_back_many(by_eta[cleaned:n])
                cleaned = n
            ws = _run_trial(base)
            trials += 1
            overuse = ws.working_table_size() - config.table_max
            balance_ok = metrics.theta(ws.loads) <= config.theta_max + 1e-9
        if (overuse <= 0 and balance_ok) or n >= n_a:
            break
        if overuse > 0:
            n = min(n_a, n + overuse)                # monotone bump (module doc)
        else:
            # Theorem-2 escalation: residual imbalance despite a fitting table
            # means stale entries pin keys badly — clean geometrically more.
            n = min(n_a, max(n + 1, 2 * max(n, 1)))
    with trace.span("plan.finish"):
        return finish(ws, assignment, config, t0, trials=float(trials),
                      cleaned=float(n))


def mixed_bf(stats: KeyStats, assignment: Assignment,
             config: BalanceConfig) -> RebalanceResult:
    """Brute force over n = 0..N_A; best feasible solution by migration cost."""
    t0 = time.perf_counter()
    psi = stats.gamma(config.beta)
    ctx = PlannerContext(stats, assignment, config, psi=psi)
    by_eta = _eta_order(stats, assignment)
    base = Workspace(ctx=ctx)
    cleaned = 0
    best_ws, best_key, best_n = None, None, 0
    for n in range(len(by_eta) + 1):
        if n > cleaned:
            base.move_back_many(by_eta[cleaned:n])
            cleaned = n
        ws = _run_trial(base)
        table_ok = ws.working_table_size() <= config.table_max
        mig = float(np.sum(ws.mem[ws.moved_mask()]))
        key = (not table_ok, mig)                    # feasible first, then min M
        if best_key is None or key < best_key:
            best_ws, best_key, best_n = ws, key, n
    return finish(best_ws, assignment, config, t0,
                  trials=float(len(by_eta) + 1), cleaned=float(best_n))
