"""Streaming keyed data pipeline partitioned by the balancer — the JAX
package's ``data/pipeline.py`` (host numpy), on the port's own ``core``.

Documents arrive from skewed sources (source id = the key; e.g. crawl
domains / dataset shards whose volume drifts). Each DP worker owns the
packing state (token backlog) of its keys — a stateful operator in the
paper's sense — so rebalancing sources across workers must migrate backlogs.
The paper's controller keeps per-worker token throughput even, which keeps
global-batch assembly from stalling on one hot worker.

Deterministic + resumable: generation is seeded per (source, interval);
``state_dict``/``load_state`` round-trips a plain dict of numbers and lists.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import (Assignment, BalanceConfig, KeyStats, ModHash,
                    RebalanceController)


def byte_tokenize(text: bytes, vocab: int) -> np.ndarray:
    """Toy reversible tokenizer: bytes (+ offset) clipped into vocab."""
    arr = np.frombuffer(text, np.uint8).astype(np.int32)
    return arr % vocab


@dataclasses.dataclass
class SourceSpec:
    source_id: int
    weight: float            # relative document volume (drifts over time)
    mean_len: int = 512      # mean document length in tokens


class KeyedDataPipeline:
    """Zipf-weighted multi-source document stream -> packed LM batches."""

    def __init__(self, sources: List[SourceSpec], n_workers: int,
                 seq_len: int, vocab: int, theta_max: float = 0.1,
                 table_max: int = 1024, seed: int = 0,
                 algorithm: str = "mixed"):
        self.sources = {s.source_id: s for s in sources}
        self.n_workers = n_workers
        self.seq_len = seq_len
        self.vocab = vocab
        self.seed = seed
        self.interval = 0
        self.backlogs: List[Dict[int, List[int]]] = [
            defaultdict(list) for _ in range(n_workers)]
        self.remainder: List[List[int]] = [[] for _ in range(n_workers)]
        self.controller = RebalanceController(
            Assignment(ModHash(n_workers, seed=seed)),
            BalanceConfig(theta_max=theta_max, table_max=table_max),
            algorithm=algorithm, executor=self._migrate)
        self._tokens_produced = np.zeros(n_workers)

    # ------------------------------------------------------------- migration
    def _migrate(self, moved_keys, old: Assignment, new: Assignment) -> None:
        moved = [int(k) for k in moved_keys]
        src = old.dest(np.asarray(moved, np.int64))
        dst = new.dest(np.asarray(moved, np.int64))
        for k, s, d in zip(moved, src, dst):
            if s == d:
                continue
            if k in self.backlogs[int(s)]:
                self.backlogs[int(d)][k] = self.backlogs[int(s)].pop(k)

    # -------------------------------------------------------------- ingest
    def _draw_documents(self, n_docs: int) -> List[Tuple[int, np.ndarray]]:
        rng = np.random.default_rng((self.seed, self.interval))
        ids = np.asarray(sorted(self.sources))
        w = np.asarray([self.sources[i].weight for i in ids], np.float64)
        w = w / w.sum()
        chosen = rng.choice(ids, size=n_docs, p=w)
        docs = []
        for sid in chosen:
            ln = max(8, int(rng.poisson(self.sources[int(sid)].mean_len)))
            docs.append((int(sid),
                         rng.integers(0, self.vocab, ln).astype(np.int32)))
        return docs

    def drift(self, rng: Optional[np.random.Generator] = None,
              magnitude: float = 0.5) -> None:
        """Short-term fluctuation: randomly re-weight a few sources."""
        rng = rng or np.random.default_rng((self.seed, self.interval, 7))
        ids = list(self.sources)
        for sid in rng.choice(ids, size=max(1, len(ids) // 10),
                              replace=False):
            self.sources[int(sid)].weight *= float(
                np.exp(rng.normal(0.0, magnitude)))

    def run_interval(self, n_docs: int = 512):
        """Ingest one interval of documents; report stats; rebalance."""
        self.interval += 1
        per_key_tokens: Dict[int, float] = defaultdict(float)
        worker_tokens = np.zeros(self.n_workers)
        for sid, tokens in self._draw_documents(n_docs):
            d = int(self.controller.assignment.dest(
                np.asarray([sid], np.int64))[0])
            self.backlogs[d][sid].extend(tokens.tolist())
            per_key_tokens[sid] += len(tokens)
            worker_tokens[d] += len(tokens)
        self._tokens_produced += worker_tokens
        # stats: cost = tokens ingested; mem = backlog size (migratable state)
        keys = np.asarray(sorted(set(per_key_tokens)
                                 | {k for b in self.backlogs for k in b}),
                          np.int64)
        if len(keys) == 0:
            return worker_tokens
        backlog_size = defaultdict(float)
        for b in self.backlogs:
            for k, toks in b.items():
                backlog_size[k] += len(toks)
        stats = KeyStats(
            keys=keys,
            cost=np.asarray([per_key_tokens.get(int(k), 0.0) for k in keys]),
            mem=np.asarray([backlog_size.get(int(k), 1.0) for k in keys]))
        self.controller.on_interval(stats)
        return worker_tokens

    # --------------------------------------------------------------- batches
    def worker_batch(self, worker: int, batch: int
                     ) -> Optional[Dict[str, np.ndarray]]:
        """Pack `batch` sequences of seq_len (+1 for labels) or None."""
        need = batch * (self.seq_len + 1)
        pool: List[int] = self.remainder[worker]
        self.remainder[worker] = []
        backlog = self.backlogs[worker]
        for k in sorted(backlog):
            if len(pool) >= need:
                break
            pool.extend(backlog[k])
            backlog[k] = []
        if len(pool) < need:
            self.remainder[worker] = pool
            return None
        self.remainder[worker] = pool[need:]
        arr = np.asarray(pool[:need], np.int32).reshape(batch,
                                                        self.seq_len + 1)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    # ------------------------------------------------------------ checkpoint
    def state_dict(self) -> dict:
        return {
            "interval": self.interval,
            "weights": {k: s.weight for k, s in self.sources.items()},
            "backlogs": [{k: list(v) for k, v in b.items()}
                         for b in self.backlogs],
            "remainder": [list(r) for r in self.remainder],
            "table": dict(self.controller.assignment.table),
        }

    def load_state(self, state: dict) -> None:
        self.interval = state["interval"]
        for k, w in state["weights"].items():
            self.sources[int(k)].weight = w
        self.backlogs = [defaultdict(list, {int(k): list(v)
                                            for k, v in b.items()})
                         for b in state["backlogs"]]
        self.remainder = [list(r) for r in state["remainder"]]
        self.controller.assignment.table = {int(k): int(v) for k, v
                                            in state["table"].items()}


def zipf_sources(n: int, z: float = 1.0, seed: int = 0) -> List[SourceSpec]:
    rng = np.random.default_rng(seed)
    w = (np.arange(1, n + 1, dtype=np.float64) ** -z)
    rng.shuffle(w)
    return [SourceSpec(i, float(w[i]), mean_len=256) for i in range(n)]
