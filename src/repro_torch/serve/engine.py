"""Serving engine: continuous batching with session-key routing — the JAX
package's ``serve/engine.py``, on the port's own control plane.

Replica groups = the paper's task instances; session ids = keys; per-session
KV cache = the migratable state. Hot sessions (agents, long contexts, high
QPS) skew replica load exactly like hot keys skew operator load; the
controller's Mixed algorithm re-routes a handful of sessions per interval and
prices each move by its KV bytes S(k, w) — sessions idle past ``window``
intervals are evicted, matching the paper's windowed state model.

The engine is model-agnostic: `decode_fn(replica, session_ids) -> tokens`
abstracts the actual serve_step; the simulation path (used by benchmarks)
charges per-token cost instead.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import numpy as np

from ..core import (Assignment, BalanceConfig, Hash32, KeyStats,
                    RebalanceController)


@dataclasses.dataclass
class Session:
    session_id: int
    context_len: int = 0           # KV entries held
    last_active: int = 0
    tokens_this_interval: int = 0


@dataclasses.dataclass
class ServeReport:
    interval: int
    requests: int
    tokens: int
    makespan: float
    throughput: float
    theta: float
    migrated_kv_bytes: float
    migrated_sessions: int
    table_size: int
    replica_loads: np.ndarray


class ServeEngine:
    def __init__(self, n_replicas: int, bytes_per_kv_token: float = 2048.0,
                 theta_max: float = 0.1, table_max: int = 4096,
                 window: int = 4, seed: int = 0, algorithm: str = "mixed",
                 decode_fn: Optional[Callable] = None):
        self.n_replicas = n_replicas
        self.bytes_per_kv = bytes_per_kv_token
        self.window = window
        self.sessions: Dict[int, Session] = {}
        self.location: Dict[int, int] = {}     # session -> replica (state)
        self.controller = RebalanceController(
            Assignment(Hash32(n_replicas, seed=seed)),
            BalanceConfig(theta_max=theta_max, table_max=table_max,
                          window=window),
            algorithm=algorithm, executor=self._migrate)
        self.decode_fn = decode_fn
        self.reports: List[ServeReport] = []
        self._interval = 0
        self._migrated_bytes = 0.0
        self._migrated_sessions = 0

    # ------------------------------------------------------------- migration
    def _migrate(self, moved_keys, old: Assignment, new: Assignment) -> None:
        ids = np.asarray([int(k) for k in moved_keys], np.int64)
        dst = new.dest(ids)
        for sid, d in zip(ids, dst):
            sess = self.sessions.get(int(sid))
            if sess is None:
                continue
            if self.location.get(int(sid)) != int(d):
                self._migrated_bytes += sess.context_len * self.bytes_per_kv
                self._migrated_sessions += 1
                self.location[int(sid)] = int(d)

    # --------------------------------------------------------------- serving
    def submit(self, session_id: int, prompt_tokens: int) -> int:
        """Route a request; create/extend its session. Returns the replica."""
        sid = int(session_id)
        d = int(self.controller.assignment.dest(np.asarray([sid],
                                                           np.int64))[0])
        sess = self.sessions.get(sid)
        if sess is None:
            sess = Session(sid)
            self.sessions[sid] = sess
            self.location[sid] = d
        sess.context_len += prompt_tokens
        sess.tokens_this_interval += prompt_tokens
        sess.last_active = self._interval
        return self.location[sid]

    def run_interval(self, requests: List) -> ServeReport:
        """requests: list of (session_id, prompt_tokens, decode_tokens)."""
        self._interval += 1
        loads = np.zeros(self.n_replicas)
        tokens = 0
        for sid, prompt, decode in requests:
            replica = self.submit(sid, prompt)
            sess = self.sessions[int(sid)]
            sess.context_len += decode
            sess.tokens_this_interval += decode
            # cost model: prefill tokens + decode tokens x context factor
            loads[replica] += prompt + decode * (
                1.0 + sess.context_len / 65536.0)
            tokens += prompt + decode
            if self.decode_fn is not None:
                self.decode_fn(replica, int(sid), prompt, decode)

        # evict idle sessions beyond the window (paper's state expiry)
        for sid in [s for s, v in self.sessions.items()
                    if self._interval - v.last_active >= self.window]:
            self.sessions.pop(sid)
            self.location.pop(sid, None)

        stats = self._stats()
        makespan = float(loads.max()) if len(requests) else 0.0
        mean = float(loads.mean()) if len(requests) else 0.0
        report = ServeReport(
            interval=self._interval, requests=len(requests), tokens=tokens,
            makespan=makespan,
            throughput=tokens / makespan if makespan > 0 else 0.0,
            theta=(makespan - mean) / mean if mean > 0 else 0.0,
            migrated_kv_bytes=self._migrated_bytes,
            migrated_sessions=self._migrated_sessions,
            table_size=self.controller.assignment.table_size,
            replica_loads=loads)
        self.reports.append(report)
        self._migrated_bytes = 0.0
        self._migrated_sessions = 0
        if stats is not None:
            self.controller.on_interval(stats)
        for sess in self.sessions.values():
            sess.tokens_this_interval = 0
        return report

    def _stats(self) -> Optional[KeyStats]:
        if not self.sessions:
            return None
        keys = np.asarray(sorted(self.sessions), np.int64)
        cost = np.asarray([self.sessions[int(k)].tokens_this_interval
                           for k in keys], np.float64)
        mem = np.asarray([self.sessions[int(k)].context_len
                          * self.bytes_per_kv for k in keys], np.float64)
        return KeyStats(keys=keys, cost=cost, mem=np.maximum(mem, 1.0))
