"""Least-Load Fit Decreasing with the Adjust exchange step (paper Alg. 1).

Array-native planner core. All phase-based algorithms (MinTable / MinMig /
Mixed) share a :class:`Workspace` over key *indices* and invoke :func:`llfd`
for Phase III; :class:`PlannerContext` holds the per-call immutable
precomputation (hash/current destinations, psi ranks, head/tail split) so the
Mixed trial loop can reuse it across its n-escalation trials.

Faithfulness notes (this is a copy of the JAX package's planner core; the
port's tests hold it bit-for-bit against that package's plans):

* the candidate set C is processed in descending order of c(k), re-evaluated
  dynamically as Adjust pushes exchanged keys back into C -> a max-heap;
* destinations are probed in ascending order of the *current estimated* load,
  ties broken by destination index (matches the k3 step of the Fig. 4 trace);
* Adjust's exchangeable set E is grown greedily in psi-order over keys
  currently on the destination with c(k') < c(k) (conditions (i)-(ii)) until
  L(d) + c(k) - sum_E c(k') <= L_max (condition (iii));
* the exchange cascade is provably finite in practice (each displaced key is
  strictly lighter than the key displacing it); a large event budget guards
  pathological inputs, falling back to plain least-load placement.

Array representation
--------------------
Psi order is computed once per planner call as a global rank permutation
(``PlannerContext.order`` / ``.rank`` — descending psi, ties by key index).
Per-destination membership is a sorted array of ranks plus a small append
buffer merged lazily on scan, so Phase II disassociation, Adjust's E and the
fallback shed are all cumsum-prefix selections instead of per-key Python
loops. Greedy-prefix decisions follow the same accumulation order as the
scalar oracle, so integer-valued workloads match bit-for-bit and continuous
ones agree unless a comparison lands within ~1 ulp of L_max (measure-zero
for randomized inputs; the parity suite runs dozens of seeds).

Head/tail split (beyond paper; cf. arXiv:1510.05714, arXiv:2308.00938)
----------------------------------------------------------------------
With ``BalanceConfig.head_fraction > 0`` only keys whose cost is at least
``head_fraction * mean_load`` — plus every key currently in the routing
table — enter the exact LLFD/Adjust machinery. The remaining tail keys stay
frozen on their hash destinations and contribute fixed base loads, so at
million-key domains the planner's working set is the heavy head only. The
default (0.0) keeps every key exact.
"""

from __future__ import annotations

import heapq
from typing import List, Optional

import numpy as np

from . import metrics
from .types import Assignment, BalanceConfig, KeyStats

IN_CANDIDATES = -1


class PlannerContext:
    """Immutable per-call precomputation shared by every Mixed trial.

    Building this once per planner call (instead of once per trial) hoists
    the two O(K log A) ``Assignment`` lookups, the psi argsort and the
    head/tail split out of the n-escalation loop.
    """

    def __init__(self, stats: KeyStats, assignment: Assignment,
                 config: BalanceConfig, psi: Optional[np.ndarray] = None):
        self.stats = stats
        self.config = config
        self.n_dest = assignment.n_dest
        self.hash_dest = assignment.hash_router(stats.keys)      # h(k) per index
        self.orig_dest = assignment.dest(stats.keys)             # F(k) per index
        self.cost = stats.cost
        self.mem = stats.mem
        # psi: priority used for Phase II selection and Adjust's E (higher first)
        self.psi = self.cost if psi is None else np.asarray(psi, dtype=np.float64)
        # sketch-mode stats carry frozen tail cost as per-dest base loads
        # (see balancer/sketch.py); they count toward the mean and sit under
        # every destination's working load but never enter the candidate set.
        self.base = metrics.base_for(stats, self.n_dest)
        base_sum = 0.0 if self.base is None else float(self.base.sum())
        self.mean_load = (float(np.sum(self.cost)) + base_sum) / self.n_dest
        k = stats.num_keys
        frac = config.head_fraction
        if frac > 0.0:
            # table keys are always head: Phase I / eta ordering needs them
            head_mask = ((self.cost >= frac * self.mean_load)
                         | (self.orig_dest != self.hash_dest))
            self.head = np.flatnonzero(head_mask).astype(np.int64)
        else:
            self.head = np.arange(k, dtype=np.int64)
        # global psi order over head keys: rank r -> key index `order[r]`,
        # descending psi, ties by ascending key index (a stable argsort of
        # -psi breaks ties by position, which is exactly the oracle's
        # (-psi, index) sort key since `head` is ascending)
        hpsi = self.psi[self.head]
        self.order = self.head[np.argsort(-hpsi, kind="stable")]
        self.rank = np.full(k, -1, dtype=np.int64)
        self.rank[self.order] = np.arange(self.order.size, dtype=np.int64)

    @property
    def is_exact(self) -> bool:
        return self.head.size == self.stats.num_keys


class Workspace:
    """Mutable rebalance state over key indices 0..K-1, flat numpy arrays.

    ``assign[i]`` is the working destination of key index i, or
    ``IN_CANDIDATES`` while the key sits in the candidate set C. Tail keys
    (head/tail mode) keep their hash destination for the whole solve.
    """

    def __init__(self, stats: Optional[KeyStats] = None,
                 assignment: Optional[Assignment] = None,
                 config: Optional[BalanceConfig] = None,
                 psi: Optional[np.ndarray] = None, *,
                 ctx: Optional[PlannerContext] = None):
        if ctx is None:
            ctx = PlannerContext(stats, assignment, config, psi=psi)
        self.ctx = ctx
        self.assign = ctx.orig_dest.copy()                       # working F'(k)
        self.loads = np.bincount(self.assign, weights=ctx.cost,
                                 minlength=ctx.n_dest).astype(np.float64)
        if ctx.base is not None:
            self.loads += ctx.base
        self.candidates: List[tuple] = []   # max-heap of (-cost, idx)
        # per-dest member ranks (sorted asc) + append buffers, built lazily:
        # Phase I mutates `assign` wholesale, so membership is materialized
        # only when Phase II / III first needs psi-ordered scans.
        self._members: Optional[List[np.ndarray]] = None
        self._extra: Optional[List[List[int]]] = None

    # -- context aliases (same attribute surface as the scalar oracle) -------
    @property
    def stats(self) -> KeyStats:
        return self.ctx.stats

    @property
    def config(self) -> BalanceConfig:
        return self.ctx.config

    @property
    def n_dest(self) -> int:
        return self.ctx.n_dest

    @property
    def hash_dest(self) -> np.ndarray:
        return self.ctx.hash_dest

    @property
    def orig_dest(self) -> np.ndarray:
        return self.ctx.orig_dest

    @property
    def cost(self) -> np.ndarray:
        return self.ctx.cost

    @property
    def mem(self) -> np.ndarray:
        return self.ctx.mem

    @property
    def psi(self) -> np.ndarray:
        return self.ctx.psi

    @property
    def mean_load(self) -> float:
        return self.ctx.mean_load

    # -- trial reuse ---------------------------------------------------------
    def clone(self) -> "Workspace":
        """O(K) array-copy snapshot; shares the immutable context."""
        ws = object.__new__(Workspace)
        ws.ctx = self.ctx
        ws.assign = self.assign.copy()
        ws.loads = self.loads.copy()
        ws.candidates = list(self.candidates)
        ws._members = None if self._members is None else list(self._members)
        ws._extra = (None if self._extra is None
                     else [list(e) for e in self._extra])
        return ws

    # -- Phase I -------------------------------------------------------------
    def move_back_many(self, idxs: np.ndarray) -> None:
        """Vectorized Phase-I 'virtual' move of keys to their hash dests."""
        idxs = np.asarray(idxs, dtype=np.int64)
        if not idxs.size:
            return
        if self._members is not None:
            for idx in idxs:                       # post-prepare: keep members
                self.move_back(int(idx))
            return
        self.assign[idxs] = self.ctx.hash_dest[idxs]
        self.loads = np.bincount(self.assign[self.assign >= 0],
                                 weights=self.ctx.cost[self.assign >= 0],
                                 minlength=self.ctx.n_dest).astype(np.float64)
        if self.ctx.base is not None:
            self.loads += self.ctx.base

    def move_back(self, idx: int) -> None:
        """Scalar Phase-I move (kept for API parity with the oracle)."""
        d_old = int(self.assign[idx])
        d_new = int(self.ctx.hash_dest[idx])
        if d_old == d_new:
            return
        if d_old != IN_CANDIDATES:
            self.loads[d_old] -= self.ctx.cost[idx]
            self._drop_member(d_old, idx)
        self.place(idx, d_new)

    # -- candidate set C ----------------------------------------------------
    def disassociate(self, idx: int) -> None:
        if self.ctx.rank[idx] < 0:
            raise ValueError(
                f"key index {idx} is a frozen tail key (head_fraction split); "
                "only head keys may enter the candidate set")
        d = int(self.assign[idx])
        if d == IN_CANDIDATES:
            return
        self.loads[d] -= self.ctx.cost[idx]
        self.assign[idx] = IN_CANDIDATES
        self._drop_member(d, idx)
        heapq.heappush(self.candidates, (-float(self.ctx.cost[idx]), int(idx)))

    def place(self, idx: int, d: int) -> None:
        self.assign[idx] = d
        self.loads[d] += self.ctx.cost[idx]
        if self._members is not None:
            r = int(self.ctx.rank[idx])
            if r < 0:
                raise ValueError(
                    f"key index {idx} is a frozen tail key (head_fraction "
                    "split); it cannot join per-destination membership")
            self._extra[d].append(r)

    # -- per-dest membership in psi order ------------------------------------
    def _ensure_members(self) -> None:
        if self._members is not None:
            return
        # dest per rank position: a stable argsort of it groups ranks by
        # destination with ranks ascending inside each group, and the
        # permutation values *are* the member ranks. IN_CANDIDATES entries
        # sort first and fall outside the [0, n_dest) segment bounds.
        dest_by_rank = self.assign[self.ctx.order]
        perm = np.argsort(dest_by_rank, kind="stable")
        seg_dest = dest_by_rank[perm]
        starts = np.searchsorted(seg_dest, np.arange(self.ctx.n_dest + 1))
        self._members = [perm[starts[d]:starts[d + 1]]
                         for d in range(self.ctx.n_dest)]
        self._extra = [[] for _ in range(self.ctx.n_dest)]

    def _members_sorted(self, d: int) -> np.ndarray:
        """Member ranks of ``d``, ascending (= psi desc, ties by key index)."""
        ex = self._extra[d]
        if ex:
            m = np.sort(np.concatenate(
                [self._members[d], np.asarray(ex, dtype=np.int64)]))
            self._members[d] = m
            self._extra[d] = []
        return self._members[d]

    def _drop_member(self, d: int, idx: int) -> None:
        if self._members is None:
            return
        r = self.ctx.rank[idx]
        m = self._members_sorted(d)
        self._members[d] = m[m != r]

    def _remove_prefix(self, d: int, m: np.ndarray, sel: np.ndarray,
                       sel_cost: np.ndarray, sel_keys: np.ndarray) -> None:
        """Disassociate ``sel`` positions of ``m`` from d (heap + loads)."""
        self.assign[sel_keys] = IN_CANDIDATES
        # sequential load updates in psi order: same accumulation as the oracle
        for c, k in zip(sel_cost.tolist(), sel_keys.tolist()):
            self.loads[d] -= c
            heapq.heappush(self.candidates, (-c, k))
        keep = np.ones(m.size, dtype=bool)
        keep[sel] = False
        self._members[d] = m[keep]

    # -- Phase II -----------------------------------------------------------
    def prepare(self) -> None:
        """Disassociate keys from every overloaded instance by psi order.

        Per overloaded destination, the scalar loop removes the greedy prefix
        of its psi-ordered members until L(d) <= L_max; a cumsum over the
        member costs selects exactly that prefix in one shot.
        """
        l_max = self.ctx.config.l_max(self.ctx.mean_load)
        self._ensure_members()
        for d in range(self.ctx.n_dest):
            if self.loads[d] <= l_max:
                continue
            m = self._members_sorted(d)
            if not m.size:
                continue
            mk = self.ctx.order[m]
            mc = self.ctx.cost[mk]
            cums = np.cumsum(mc)
            # key j is shed iff the load before removing it still exceeds L_max
            nrm = int(np.count_nonzero(self.loads[d] - (cums - mc) > l_max))
            if nrm == 0:
                continue
            self._remove_prefix(d, m, np.arange(nrm), mc[:nrm], mk[:nrm])

    # -- Phase III helpers ---------------------------------------------------
    def _try_exchange(self, idx: int, d: int, l_max: float) -> bool:
        """Adjust's E (conditions (i)-(iii)): cumsum-prefix over strictly
        lighter members of ``d`` in psi order; disassociate it on success."""
        c_k = self.ctx.cost[idx]
        m = self._members_sorted(d)
        if not m.size:
            return False
        mk = self.ctx.order[m]
        mc = self.ctx.cost[mk]
        epos = np.flatnonzero(mc < c_k)                          # (i) + (ii)
        if not epos.size:
            return False
        ec = mc[epos]
        cums = np.cumsum(ec)
        need = self.loads[d] + c_k - l_max
        p = int(np.searchsorted(cums, need, side="left"))
        if p >= ec.size:                                         # (iii) fails
            return False
        sel = epos[:p + 1]
        self._remove_prefix(d, m, sel, ec[:p + 1], mk[sel])
        return True

    def _fallback_place(self, idx: int, l_max: float) -> None:
        """Oversized-key fallback: least-load placement + relaxed-(iii) shed.

        The paper's analysis assumes c(k1) < mean so this case is outside
        Theorems 1/2; in production it happens (one key heavier than L_max,
        e.g. one expert hotter than a whole shard's budget). Place least-load,
        then shed strictly-lighter keys until the destination carries no more
        than the oversized key demands.
        """
        d = int(np.argmin(self.loads))
        self.place(idx, d)
        target = max(l_max, float(self.ctx.cost[idx]))
        if self.loads[d] <= target:
            return
        m = self._members_sorted(d)
        mk = self.ctx.order[m]
        mc = self.ctx.cost[mk]
        epos = np.flatnonzero(mc < self.ctx.cost[idx])    # idx itself excluded
        if not epos.size:
            return
        ec = mc[epos]
        cums = np.cumsum(ec)
        nrm = int(np.count_nonzero(self.loads[d] - (cums - ec) > target))
        if nrm == 0:
            return
        sel = epos[:nrm]
        self._remove_prefix(d, m, sel, ec[:nrm], mk[sel])

    # -- derived outputs ----------------------------------------------------
    def working_table_size(self) -> int:
        """|A'| of the working assignment (valid once C is drained)."""
        return int(np.count_nonzero(self.assign != self.ctx.hash_dest))

    def result_table(self) -> dict:
        """A' = {key id -> dest}  for keys whose working dest != hash dest."""
        diff = self.assign != self.ctx.hash_dest
        ids = self.ctx.stats.keys[diff]
        dst = self.assign[diff]
        return {int(k): int(d) for k, d in zip(ids, dst)}

    def moved_mask(self) -> np.ndarray:
        return self.assign != self.ctx.orig_dest


def llfd(ws: Workspace) -> None:
    """Phase III: drain the candidate heap (paper Alg. 1 lines 1-9).

    Mutates ``ws`` in place; the routing table is derived afterwards via
    ``ws.result_table()``. The heap pop order (cost desc, ties by key index)
    and the least-load destination probe (ties by destination index) match
    the scalar oracle exactly.
    """
    ws._ensure_members()
    l_max = ws.ctx.config.l_max(ws.ctx.mean_load)
    events = 0
    budget = ws.ctx.config.max_llfd_events
    heap = ws.candidates
    assign = ws.assign
    cost = ws.ctx.cost
    while heap:
        neg_c, idx = heapq.heappop(heap)
        if assign[idx] != IN_CANDIDATES:     # stale heap entry
            continue
        events += 1
        placed = False
        if events <= budget:
            c_k = cost[idx]
            order = np.argsort(ws.loads, kind="stable")  # asc load, ties by d
            for d in order:
                d = int(d)
                if (ws.loads[d] + c_k <= l_max
                        or ws._try_exchange(idx, d, l_max)):
                    ws.place(idx, d)
                    placed = True
                    break
        if not placed:
            ws._fallback_place(idx, l_max)
