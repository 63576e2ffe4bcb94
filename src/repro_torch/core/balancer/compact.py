"""Compact 6-d representation and the adapted Mixed over it (paper Sec. IV-A).

Keys with identical (d, d_hash, v_c, v_S) collapse into one vector
``(d', d, d_hash, v_c, v_S, #)``; v_c / v_S are HLHE-discretized (Sec. IV-B).
The adapted phases manipulate vectors; concrete keys are materialized only at
the end, for Delta(F, F') and the routing table.

Vector-splitting note: the paper moves whole vectors but merges vectors that
agree on all five descriptor fields; since every unit inside a vector is
indistinguishable, splitting a vector's count across destinations is
semantically free and strictly improves balance. We place unit-by-unit
batches (the complexity stays O(#vectors * N_D), not O(K)).
"""

from __future__ import annotations

import heapq
import time
from collections import defaultdict
from typing import Dict, Tuple

import numpy as np

from . import metrics
from .discretize import discretize
from .types import Assignment, BalanceConfig, KeyStats, RebalanceResult

NIL = -1
GKey = Tuple[int, int, float, float]          # (d, dh, v_c, v_S) origin group
PKey = Tuple[int, int, float, float, int]     # + d' working placement


def build_groups(stats: KeyStats, assignment: Assignment,
                 r) -> Tuple[Dict[GKey, int], np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Collapse keys into origin groups. Returns (groups, d, dh, vc, vs arrays)."""
    groups, d, dh, vc, vs, _, _ = build_groups_indexed(stats, assignment, r)
    return groups, d, dh, vc, vs


def build_groups_indexed(stats: KeyStats, assignment: Assignment, r):
    """Vectorized grouping; also returns (inverse, uniq) for fast expansion."""
    d = assignment.dest(stats.keys)
    dh = assignment.hash_router(stats.keys)
    # normalize to >= 1 for HLHE (paper assumes normalized values)
    cost = np.maximum(stats.cost, 1.0)
    mem = np.maximum(stats.mem, 1.0)
    if r is None:
        vc, vs = cost, mem
    else:
        vc, vs = discretize(cost, r), discretize(mem, r)
    mat = np.column_stack([d.astype(np.float64), dh.astype(np.float64), vc, vs])
    uniq, inverse, counts = np.unique(mat, axis=0, return_inverse=True,
                                      return_counts=True)
    groups: Dict[GKey, int] = {
        (int(row[0]), int(row[1]), float(row[2]), float(row[3])): int(c)
        for row, c in zip(uniq, counts)}
    return groups, d, dh, vc, vs, inverse.ravel(), uniq


class _CompactWs:
    """Working placement: (origin group, d') -> unit count."""

    def __init__(self, groups: Dict[GKey, int], n_dest: int, config: BalanceConfig):
        self.placed: Dict[PKey, int] = {}
        self.cands: Dict[GKey, int] = defaultdict(int)
        self.n_dest = n_dest
        self.config = config
        self.loads = np.zeros((n_dest,), dtype=np.float64)
        total = 0.0
        for (d, dh, vc, vs), cnt in groups.items():
            self.placed[(d, dh, vc, vs, d)] = cnt
            self.loads[d] += vc * cnt
            total += vc * cnt
        self.mean = total / n_dest
        self.events = 0

    # unit bookkeeping ------------------------------------------------------
    def _take(self, pkey: PKey, n: int) -> None:
        cur = self.placed.get(pkey, 0)
        if cur < n:
            raise ValueError("taking more units than placed")
        if cur == n:
            self.placed.pop(pkey)
        else:
            self.placed[pkey] = cur - n
        self.loads[pkey[4]] -= pkey[2] * n

    def _put(self, gkey: GKey, dprime: int, n: int) -> None:
        pkey = (gkey[0], gkey[1], gkey[2], gkey[3], dprime)
        self.placed[pkey] = self.placed.get(pkey, 0) + n
        self.loads[dprime] += gkey[2] * n

    def disassociate(self, pkey: PKey, n: int) -> None:
        self._take(pkey, n)
        self.cands[pkey[:4]] += n

    def gamma(self, vc: float, vs: float) -> float:
        return (vc ** self.config.beta) / max(vs, 1e-12)

    # Phase II ---------------------------------------------------------------
    def prepare(self) -> None:
        l_max = self.config.l_max(self.mean)
        for d in range(self.n_dest):
            if self.loads[d] <= l_max:
                continue
            members = [p for p in self.placed if p[4] == d]
            members.sort(key=lambda p: -self.gamma(p[2], p[3]))
            for p in members:
                if self.loads[d] <= l_max:
                    break
                excess = self.loads[d] - l_max
                n_rm = min(self.placed[p], int(np.ceil(excess / p[2])))
                self.disassociate(p, n_rm)

    # Phase III: group LLFD ----------------------------------------------------
    def llfd(self) -> None:
        l_max = self.config.l_max(self.mean)
        heap = [(-g[2], g) for g, c in self.cands.items() if c > 0]
        heapq.heapify(heap)
        budget = self.config.max_llfd_events
        while heap:
            self.events += 1
            _, gkey = heapq.heappop(heap)
            cnt = self.cands.get(gkey, 0)
            if cnt <= 0:
                continue
            vc = gkey[2]
            placed_any = False
            if self.events <= budget:
                for d in np.argsort(self.loads, kind="stable"):
                    d = int(d)
                    fit = int(np.floor((l_max - self.loads[d]) / vc))
                    if fit >= 1:
                        n = min(cnt, fit)
                        self.cands[gkey] -= n
                        self._put(gkey, d, n)
                        placed_any = True
                        break
                    if self._exchange_one(gkey, d, l_max, heap):
                        placed_any = True
                        break
            if not placed_any:
                # oversized-unit fallback (mirrors llfd.py): place least-load,
                # then shed strictly-lighter units down to what the unit needs.
                d = int(np.argmin(self.loads))
                self.cands[gkey] = 0
                self._put(gkey, d, cnt)
                target = max(l_max, vc * cnt)
                members = [p for p in self.placed
                           if p[4] == d and p[2] < vc]
                members.sort(key=lambda p: -self.gamma(p[2], p[3]))
                for p in members:
                    if self.loads[d] <= target:
                        break
                    excess = self.loads[d] - target
                    n_rm = min(self.placed[p], int(np.ceil(excess / p[2])))
                    self.disassociate(p, n_rm)
                    heapq.heappush(heap, (-p[2], p[:4]))
                continue
            if self.cands.get(gkey, 0) > 0:
                heapq.heappush(heap, (-vc, gkey))     # remainder retries

    def _exchange_one(self, gkey: GKey, d: int, l_max: float, heap) -> bool:
        """Adjust for one unit of gkey onto d: displace strictly-lighter units."""
        vc = gkey[2]
        exch = [p for p in self.placed if p[4] == d and p[2] < vc]
        if not exch:
            return False
        exch.sort(key=lambda p: -self.gamma(p[2], p[3]))
        need = self.loads[d] + vc - l_max
        plan = []
        removed = 0.0
        for p in exch:
            if removed >= need:
                break
            n_av = self.placed[p]
            n_rm = min(n_av, int(np.ceil((need - removed) / p[2])))
            plan.append((p, n_rm))
            removed += p[2] * n_rm
        if removed < need:
            return False
        for p, n_rm in plan:
            self.disassociate(p, n_rm)
            heapq.heappush(heap, (-p[2], p[:4]))
        self.cands[gkey] -= 1
        self._put(gkey, d, 1)
        return True

    # outputs -----------------------------------------------------------------
    def splits(self) -> Dict[GKey, Dict[int, int]]:
        """origin group -> {d' -> units}."""
        out: Dict[GKey, Dict[int, int]] = defaultdict(dict)
        for p, cnt in self.placed.items():
            if cnt > 0:
                out[p[:4]][p[4]] = out[p[:4]].get(p[4], 0) + cnt
        return dict(out)


def compact_mixed(stats: KeyStats, assignment: Assignment, config: BalanceConfig,
                  r=None) -> RebalanceResult:
    """Adapted Mixed (paper Sec. IV-A) over the compact representation.

    ``r`` = HLHE degree of discretization (None = exact values; the vector
    space then collapses only identical-valued keys).
    """
    t0 = time.perf_counter()
    r = config.discretize_r if r is None else r
    (groups, d_arr, dh_arr, vc_arr, vs_arr, inverse,
     uniq) = build_groups_indexed(stats, assignment, r)
    n_dest = assignment.n_dest

    # eta order for Phase I: table vectors (d != dh), smallest v_S first
    table_groups = sorted((g for g in groups if g[0] != g[1]),
                          key=lambda g: (g[3], g))
    n = 0
    trials = 0
    while True:
        ws = _CompactWs(groups, n_dest, config)
        left = n
        for g in table_groups:                       # Phase I: move back n units
            if left <= 0:
                break
            pk = (g[0], g[1], g[2], g[3], g[0])
            avail = ws.placed.get(pk, 0)
            take = min(avail, left)
            if take > 0:
                ws._take(pk, take)
                ws._put(g, g[1], take)               # back to hash destination
                left -= take
        ws.prepare()                                 # Phase II
        ws.llfd()                                    # Phase III
        trials += 1
        # estimated table size: units whose final dest != dh
        est_table = sum(cnt for p, cnt in ws.placed.items() if p[4] != p[1])
        overuse = est_table - config.table_max
        max_units = sum(groups[g] for g in table_groups)
        if overuse <= 0 or n >= max_units:
            break
        n = min(max_units, n + overuse)

    # ---- expand vectors back to concrete keys (paper Phase III (i)-(iii)) ----
    # keys sorted by group id; group g occupies by_group[starts[g]:starts[g+1]]
    final = d_arr.copy()
    gamma_true = stats.gamma(config.beta)
    by_group = np.argsort(inverse, kind="stable")
    starts = np.searchsorted(inverse[by_group], np.arange(len(uniq) + 1))
    gid_of = {(int(row[0]), int(row[1]), float(row[2]), float(row[3])): g
              for g, row in enumerate(uniq)}
    for gkey, split in ws.splits().items():
        movers = {dp: cnt for dp, cnt in split.items() if dp != gkey[0]}
        if not movers:
            continue
        g = gid_of.get(gkey)
        if g is None:
            continue
        idxs = by_group[starts[g]:starts[g + 1]]
        idxs = idxs[np.argsort(-gamma_true[idxs], kind="stable")]  # psi order
        pos = 0
        for dp in sorted(movers):
            cnt = movers[dp]
            final[idxs[pos:pos + cnt]] = dp
            pos += cnt

    diff = final != dh_arr
    table = {int(k): int(d) for k, d in zip(stats.keys[diff], final[diff])}
    new = Assignment(assignment.hash_router, table)
    moved = final != d_arr
    true_loads = np.bincount(final, weights=stats.cost,
                             minlength=n_dest).astype(np.float64)
    th = metrics.theta(true_loads)
    est_err = float(np.max(np.abs(ws.loads - true_loads)) /
                    max(np.mean(true_loads), 1e-12))
    return RebalanceResult(
        assignment=new, moved_keys=stats.keys[moved],
        migration_cost=float(np.sum(stats.mem[moved])), loads=true_loads,
        table_size=len(table), theta=th,
        feasible_balance=th <= config.theta_max + 1e-9,
        feasible_table=len(table) <= config.table_max,
        plan_time_s=time.perf_counter() - t0,
        meta={"groups": float(len(groups)), "trials": float(trials),
              "load_est_err": est_err},
    )
