"""Reference (per-key Python) planner — the parity oracle for ``llfd.py``.

This module keeps the scalar implementation of the paper's Alg. 1/4
planner: a :class:`ReferenceWorkspace` over Python sets and heaps,
``sorted(..., key=lambda)`` psi orders, and a Mixed trial loop that rebuilds
the workspace from scratch for every ``n``-escalation step.

The production planner (:mod:`.llfd`) is array-native and must produce
*bit-identical* plans (routing table, moved keys, loads, theta) in its
default exact mode; these functions are the oracle that claim is held
against, and the registry serves them as ``*_reference`` planners for A/B
runs.

Do not optimize this module: being slow-and-obvious is its job.
"""

from __future__ import annotations

import heapq
import time
from typing import Iterable, List, Optional, Set

import numpy as np

from . import metrics
from .phased import finish
from .types import Assignment, BalanceConfig, KeyStats, RebalanceResult

IN_CANDIDATES = -1


class ReferenceWorkspace:
    """Mutable rebalance state over key indices 0..K-1 (scalar structures).

    ``assign[i]`` is the working destination of key index i, or
    ``IN_CANDIDATES`` while the key sits in the candidate set C.
    """

    def __init__(self, stats: KeyStats, assignment: Assignment, config: BalanceConfig,
                 psi: Optional[np.ndarray] = None):
        self.stats = stats
        self.config = config
        self.n_dest = assignment.n_dest
        self.hash_dest = assignment.hash_router(stats.keys)      # h(k) per index
        self.orig_dest = assignment.dest(stats.keys)             # F(k) per index
        self.assign = self.orig_dest.copy()                      # working F'(k)
        self.cost = stats.cost
        self.mem = stats.mem
        # psi: priority used for Phase II selection and Adjust's E (higher first)
        self.psi = self.cost if psi is None else np.asarray(psi, dtype=np.float64)
        self.loads = np.bincount(self.assign, weights=self.cost,
                                 minlength=self.n_dest).astype(np.float64)
        self.mean_load = float(np.sum(self.cost)) / self.n_dest
        self.dest_keys: List[Set[int]] = [set() for _ in range(self.n_dest)]
        for i, d in enumerate(self.assign):
            self.dest_keys[int(d)].add(i)
        self.candidates: List[tuple] = []   # max-heap of (-cost, idx)

    # -- candidate set C ----------------------------------------------------
    def disassociate(self, idx: int) -> None:
        d = int(self.assign[idx])
        if d == IN_CANDIDATES:
            return
        self.dest_keys[d].discard(idx)
        self.loads[d] -= self.cost[idx]
        self.assign[idx] = IN_CANDIDATES
        heapq.heappush(self.candidates, (-float(self.cost[idx]), int(idx)))

    def place(self, idx: int, d: int) -> None:
        self.assign[idx] = d
        self.dest_keys[d].add(idx)
        self.loads[d] += self.cost[idx]

    def move_back(self, idx: int) -> None:
        """Phase-I style 'virtual' move of a key to its hash destination."""
        d_old = int(self.assign[idx])
        d_new = int(self.hash_dest[idx])
        if d_old == d_new:
            return
        if d_old != IN_CANDIDATES:
            self.dest_keys[d_old].discard(idx)
            self.loads[d_old] -= self.cost[idx]
        self.place(idx, d_new)

    # -- Phase II -----------------------------------------------------------
    def prepare(self) -> None:
        """Disassociate keys from every overloaded instance by psi order."""
        l_max = self.config.l_max(self.mean_load)
        for d in range(self.n_dest):
            if self.loads[d] <= l_max:
                continue
            members = sorted(self.dest_keys[d],
                             key=lambda i: (-self.psi[i], i))
            for idx in members:
                if self.loads[d] <= l_max:
                    break
                self.disassociate(idx)

    # -- derived outputs ----------------------------------------------------
    def result_table(self) -> dict:
        """A' = {key id -> dest}  for keys whose working dest != hash dest."""
        diff = self.assign != self.hash_dest
        ids = self.stats.keys[diff]
        dst = self.assign[diff]
        return {int(k): int(d) for k, d in zip(ids, dst)}

    def moved_mask(self) -> np.ndarray:
        return self.assign != self.orig_dest


def _find_exchange_set(ws: ReferenceWorkspace, idx: int, d: int,
                       l_max: float) -> Optional[List[int]]:
    """Adjust's exchangeable set E (conditions (i)-(iii)), greedy in psi order."""
    c_k = ws.cost[idx]
    cands = [j for j in ws.dest_keys[d] if ws.cost[j] < c_k]        # (i) + (ii)
    if not cands:
        return None
    cands.sort(key=lambda j: (-ws.psi[j], j))
    need = ws.loads[d] + c_k - l_max
    out: List[int] = []
    removed = 0.0
    for j in cands:
        if removed >= need:
            break
        out.append(j)
        removed += ws.cost[j]
    if removed >= need:                                              # (iii)
        return out
    return None


def _adjust(ws: ReferenceWorkspace, idx: int, d: int, l_max: float) -> bool:
    """Paper Alg. 1 lines 10-20."""
    if ws.loads[d] + ws.cost[idx] <= l_max:
        return True
    exch = _find_exchange_set(ws, idx, d, l_max)
    if exch is None:
        return False
    for j in exch:
        ws.disassociate(j)
    return True


def reference_llfd(ws: ReferenceWorkspace) -> None:
    """Phase III: drain the candidate heap (paper Alg. 1 lines 1-9)."""
    l_max = ws.config.l_max(ws.mean_load)
    events = 0
    budget = ws.config.max_llfd_events
    while ws.candidates:
        neg_c, idx = heapq.heappop(ws.candidates)
        if ws.assign[idx] != IN_CANDIDATES:     # stale heap entry
            continue
        events += 1
        placed = False
        if events <= budget:
            order = np.argsort(ws.loads, kind="stable")  # ascending load, ties by index
            for d in order:
                if _adjust(ws, idx, int(d), l_max):
                    ws.place(idx, int(d))
                    placed = True
                    break
        if not placed:
            # No destination admits this key even with exchanges — place
            # least-load, then shed strictly-lighter keys until the
            # destination carries no more than the oversized key demands
            # (Adjust with relaxed (iii)). See llfd.py for the full rationale.
            d = int(np.argmin(ws.loads))
            ws.place(idx, d)
            target = max(l_max, float(ws.cost[idx]))
            if ws.loads[d] > target:
                members = sorted(
                    (j for j in ws.dest_keys[d]
                     if j != idx and ws.cost[j] < ws.cost[idx]),
                    key=lambda j: (-ws.psi[j], j))
                for j in members:
                    if ws.loads[d] <= target:
                        break
                    ws.disassociate(j)


def seed_candidates(ws: ReferenceWorkspace, idxs: Iterable[int]) -> None:
    for idx in idxs:
        ws.disassociate(int(idx))


# -- the scalar twin of phased.run_phases ------------------------------------

def reference_run_phases(stats: KeyStats, assignment: Assignment,
                         config: BalanceConfig, *,
                         psi: Optional[np.ndarray] = None,
                         clean_idxs: Optional[np.ndarray] = None
                         ) -> ReferenceWorkspace:
    """Phase I (move back ``clean_idxs``) -> Phase II -> Phase III (LLFD)."""
    ws = ReferenceWorkspace(stats, assignment, config, psi=psi)
    if clean_idxs is not None:
        for idx in np.asarray(clean_idxs, dtype=np.int64):
            ws.move_back(int(idx))
    ws.prepare()
    reference_llfd(ws)
    return ws


def _ref_table_key_indices(stats: KeyStats, assignment: Assignment) -> np.ndarray:
    """Scalar table membership: O(K log K) np.isin, recomputed per call."""
    if not assignment.table:
        return np.zeros((0,), dtype=np.int64)
    tkeys = np.fromiter(assignment.table.keys(), dtype=np.int64,
                        count=len(assignment.table))
    return np.flatnonzero(np.isin(stats.keys, tkeys))


def _eta_order(stats: KeyStats, assignment: Assignment) -> np.ndarray:
    """Table-key indices sorted by smallest memory consumption S(k,w) first."""
    idx = _ref_table_key_indices(stats, assignment)
    return idx[np.argsort(stats.mem[idx], kind="stable")]


def _trial(stats: KeyStats, assignment: Assignment, config: BalanceConfig,
           table_idx_by_eta: np.ndarray, n: int, psi: np.ndarray):
    clean = table_idx_by_eta[:n] if n > 0 else None
    return reference_run_phases(stats, assignment, config, psi=psi,
                                clean_idxs=clean)


def reference_mintable(stats: KeyStats, assignment: Assignment,
                       config: BalanceConfig) -> RebalanceResult:
    t0 = time.perf_counter()
    clean = _ref_table_key_indices(stats, assignment)    # Phase I: all of A
    ws = reference_run_phases(stats, assignment, config, psi=stats.cost,
                              clean_idxs=clean)
    return finish(ws, assignment, config, t0, cleaned=float(len(clean)))


def reference_minmig(stats: KeyStats, assignment: Assignment,
                     config: BalanceConfig) -> RebalanceResult:
    t0 = time.perf_counter()
    ws = reference_run_phases(stats, assignment, config,
                              psi=stats.gamma(config.beta), clean_idxs=None)
    return finish(ws, assignment, config, t0)


def reference_mixed(stats: KeyStats, assignment: Assignment,
                    config: BalanceConfig) -> RebalanceResult:
    """Scalar Mixed: a full workspace rebuild per trial."""
    t0 = time.perf_counter()
    psi = stats.gamma(config.beta)
    by_eta = _eta_order(stats, assignment)
    n_a = len(by_eta)
    n = 0
    trials = 0
    while True:
        ws = _trial(stats, assignment, config, by_eta, n, psi)
        trials += 1
        overuse = len(ws.result_table()) - config.table_max
        balance_ok = metrics.theta(ws.loads) <= config.theta_max + 1e-9
        if (overuse <= 0 and balance_ok) or n >= n_a:
            break
        if overuse > 0:
            n = min(n_a, n + overuse)                # monotone bump
        else:
            # Theorem-2 escalation: residual imbalance despite a fitting table
            # means stale entries pin keys badly — clean geometrically more.
            n = min(n_a, max(n + 1, 2 * max(n, 1)))
    return finish(ws, assignment, config, t0, trials=float(trials),
                  cleaned=float(n))


def reference_mixed_bf(stats: KeyStats, assignment: Assignment,
                       config: BalanceConfig) -> RebalanceResult:
    """Brute force over n = 0..N_A; best feasible solution by migration cost."""
    t0 = time.perf_counter()
    psi = stats.gamma(config.beta)
    by_eta = _eta_order(stats, assignment)
    best_ws, best_key, best_n = None, None, 0
    for n in range(len(by_eta) + 1):
        ws = _trial(stats, assignment, config, by_eta, n, psi)
        table_ok = len(ws.result_table()) <= config.table_max
        mig = float(np.sum(ws.mem[ws.moved_mask()]))
        key = (not table_ok, mig)                    # feasible first, then min M
        if best_key is None or key < best_key:
            best_ws, best_key, best_n = ws, key, n
    return finish(best_ws, assignment, config, t0,
                  trials=float(len(by_eta) + 1), cleaned=float(best_n))


REFERENCE_ALGORITHMS = {
    "mintable": reference_mintable,
    "minmig": reference_minmig,
    "mixed": reference_mixed,
    "mixed_bf": reference_mixed_bf,
}
