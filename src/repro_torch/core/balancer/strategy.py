"""Partitioning strategies: one protocol over interval planners and routers.

The paper's Mixed/MinTable/MinMig family and the competing partitioners it
evaluates against (PKG [1510.07623], the Power of Both Choices [1504.00788],
W-Choices [1510.05714]) are different *shapes* of algorithm:

* **table planners** solve a per-interval optimization producing a new
  assignment function F' (routing table + hash) and a migration plan — every
  tuple of a key goes to F(k), state moves when F changes;
* **choice routers** pick a destination per *tuple* from a small stable
  candidate set per key using live load estimates — a key's tuples split
  across candidates, nothing ever migrates, and non-commutative per-key
  aggregates need a downstream merge stage.

Both sit behind the :class:`PartitionStrategy` protocol and a registry:
strategies are *registered*, not if/elif'd — :func:`register_strategy` +
:func:`strategy_names` + :func:`resolve_strategy` — and carry capability
flags (``plans_migration``, ``needs_merge_stage``) that the controller and
engine consult instead of name-matching.

One ``algorithm=`` spec grammar (the controller, ``KeyedStage`` and
``keyed_stage()`` accept exactly this and delegate here):

* a **name** from :func:`strategy_names` — resolved to a fresh instance;
* a **callable** ``(stats, assignment, config) -> RebalanceResult`` — the
  planner signature, wrapped as a :class:`TablePlanner`;
* a **configured** :class:`PartitionStrategy` **instance** — used as-is
  (routers are stateful: one instance per controller).

Every strategy the JAX package registers is registered here too: the table
planners in ``balancer/__init__.py``, the three routers below. The legacy
``ALGORITHMS`` dict survives as a read-only deprecated view over the
registered table planners (:data:`ALGORITHMS`), as in the JAX package;
resolve through the registry instead.

Choice-router semantics
-----------------------
Candidate sets are pure hash functions of the key — ``d`` independent
:class:`~repro_torch.core.balancer.hashing.Hash32` draws (the
device-canonical fmix32 family), so they are stable across batches,
restarts and router instances. Routing is host numpy, vectorized in chunks:
within a chunk each key's tuples round-robin over its candidates starting
from the currently least-loaded one (ties break toward the earlier hash,
matching the sequential greedy of
:func:`~repro_torch.core.balancer.pkg.pkg_route`), and per-worker
tuple-count loads update between chunks — the power-of-d-choices policy
under slightly stale loads, the regime the PKG paper proves safe. Each
chunk's destinations depend on the loads the previous chunk left, so the
candidates are not sent through the routing kernel (a launch per chunk).
"""

from __future__ import annotations

import warnings
from collections.abc import Mapping
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from .hashing import GOLDEN_SEED_STRIDE, Hash32
from .sketch import SpaceSavingTracker
from .types import Assignment, BalanceConfig, KeyStats, RebalanceResult

#: name -> zero-arg factory returning a fresh strategy instance. Mutated only
#: through :func:`register_strategy` / :func:`register_planner`.
STRATEGIES: Dict[str, Callable[[], "PartitionStrategy"]] = {}

#: seed spacing between the d candidate hashes — the shared golden-ratio
#: constant, also used by the count-min sketch rows
_CHOICE_SEED_STRIDE = GOLDEN_SEED_STRIDE


def register_strategy(factory):
    """Register a strategy factory under ``factory.name`` (decorator-friendly)."""
    name = getattr(factory, "name", None)
    if not name:
        raise ValueError(f"{factory!r} needs a non-empty 'name'")
    STRATEGIES[name] = factory
    return factory


def strategy_names() -> Tuple[str, ...]:
    """Every resolvable ``algorithm=`` name, sorted."""
    return tuple(sorted(STRATEGIES))


def get_strategy(name: str):
    """The registered factory for ``name`` (class or callable)."""
    if name not in STRATEGIES:
        raise ValueError(f"unknown algorithm {name!r}; "
                         f"choose from {list(strategy_names())}")
    return STRATEGIES[name]


def resolve_strategy(spec) -> "PartitionStrategy":
    """Map an ``algorithm=`` spec (name | callable | instance) to a strategy.

    Names yield a *fresh* instance per call (routers carry per-controller
    load state); instances pass through unchanged; bare callables with the planner signature are wrapped in a
    :class:`TablePlanner` (``name`` taken from ``__name__``).
    """
    if isinstance(spec, PartitionStrategy):
        return spec
    if callable(spec):
        return TablePlanner(spec)
    return get_strategy(spec)()


class PartitionStrategy:
    """Protocol for partitioning strategies (capability-flag driven).

    * ``name`` — registry key / ``algorithm_name`` surfaced by controllers.
    * ``kind`` — ``"planner"`` or ``"router"``.
    * ``plans_migration`` — True when the strategy produces rebalance plans
      that move state (table planners); False for routers, which never
      migrate (the controller skips trigger/plan/executor entirely).
    * ``needs_merge_stage`` — True when the strategy may split one key's
      tuples across workers, so the engine refuses operators without
      ``split_safe`` (see :mod:`repro_torch.streams.topology`).

    The controller calls :meth:`bind` once with its assignment (routers size
    their load vectors and derive candidate-hash seeds from it); planners
    then serve :meth:`plan` per triggered interval, routers serve
    :meth:`route` per batch and :meth:`on_stats` per interval.
    """

    name: str = ""
    kind: str = "planner"
    plans_migration: bool = True
    needs_merge_stage: bool = False

    @property
    def is_router(self) -> bool:
        return self.kind == "router"

    def bind(self, assignment: Assignment) -> None:
        """Attach to a controller's assignment (called once per controller)."""

    def plan(self, stats: KeyStats, assignment: Assignment,
             config: BalanceConfig) -> RebalanceResult:
        raise NotImplementedError(f"{self.name!r} is not a table planner")

    def route(self, keys: np.ndarray) -> np.ndarray:
        """Per-tuple destinations for one batch (stateful: advances loads)."""
        raise NotImplementedError(f"{self.name!r} is not a choice router")

    def on_stats(self, stats: KeyStats) -> None:
        """Interval-boundary measurement hook (e.g. head-key refresh)."""

    @property
    def loads(self) -> np.ndarray:
        """Per-worker routed tuple counts (router load estimate)."""
        raise NotImplementedError(f"{self.name!r} is not a choice router")


class TablePlanner(PartitionStrategy):
    """A paper-family interval planner behind the strategy protocol: wraps
    the ``(stats, assignment, config) -> RebalanceResult`` callable."""

    kind = "planner"
    plans_migration = True
    needs_merge_stage = False

    def __init__(self, fn, name: Optional[str] = None):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "custom")

    def plan(self, stats, assignment, config) -> RebalanceResult:
        return self.fn(stats, assignment, config)


#: raw name -> planner callable for the registered table planners — the
#: backing store of the deprecated :data:`ALGORITHMS` view.
PLANNERS: Dict[str, Callable] = {}


def register_planner(name: str, fn) -> None:
    """Register a planner callable under ``name`` as a :class:`TablePlanner`."""
    PLANNERS[name] = fn
    STRATEGIES[name] = lambda fn=fn, name=name: TablePlanner(fn, name)


def _occurrence_index(inv: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """occ[i] = earlier tuples in the chunk sharing keys[i]'s key (the same
    closed form the operators use; a local copy keeps the balancer package
    independent of the streams package)."""
    order = np.argsort(inv, kind="stable")
    starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
    occ = np.empty(inv.size, dtype=np.int64)
    occ[order] = np.arange(inv.size, dtype=np.int64) - np.repeat(starts,
                                                                 counts)
    return occ


class ChoiceRouter(PartitionStrategy):
    """Power-of-d-choices per-tuple router (PKG's scheme, d=2 by default).

    Every key has ``n_choices`` stable candidate destinations (independent
    :class:`~repro_torch.core.balancer.hashing.Hash32` draws seeded off the
    controller's router seed); tuples go to candidates in least-loaded-first
    round-robin, vectorized chunk by chunk (see the module docstring).

    ``candidate_fn`` (tests / worked examples) overrides the hash-derived
    candidate matrix: ``candidate_fn(unique_keys) -> (U, d) int array``.
    """

    name = "pkg"
    kind = "router"
    plans_migration = False
    needs_merge_stage = True

    def __init__(self, n_choices: int = 2, chunk: int = 512,
                 seed: Optional[int] = None, candidate_fn=None):
        if n_choices < 1:
            raise ValueError("n_choices must be >= 1")
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        self.n_choices = int(n_choices)
        self.chunk = int(chunk)
        self._seed_override = seed
        self.candidate_fn = candidate_fn
        self.n_dest = 0
        self.seed = 0
        self._hashes: list = []
        self._loads = np.zeros(0, dtype=np.float64)

    def bind(self, assignment: Assignment) -> None:
        self.n_dest = assignment.n_dest
        self.seed = (self._seed_override if self._seed_override is not None
                     else getattr(assignment.hash_router, "seed", 0))
        self._hashes = [
            Hash32(self.n_dest, seed=self.seed + j * _CHOICE_SEED_STRIDE)
            for j in range(self.n_choices)]
        self._loads = np.zeros(self.n_dest, dtype=np.float64)

    @property
    def loads(self) -> np.ndarray:
        return self._loads

    # -- candidate sets (stable per key) ---------------------------------------
    def candidates(self, keys: np.ndarray) -> np.ndarray:
        """(len(keys), d) candidate destinations — a pure function of the
        key, so identical across batches and router instances with the same
        (n_dest, seed)."""
        keys = np.asarray(keys, dtype=np.int64)
        if self.candidate_fn is not None:
            return np.asarray(self.candidate_fn(keys), dtype=np.int64)
        return np.stack([h(keys) for h in self._hashes], axis=1)

    def _candidate_matrix(self, uk: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """(U, dmax) candidate matrix + (U,) per-key choice count. Subclasses
        may widen selected keys' candidate sets (W-Choices)."""
        cand = self.candidates(uk)
        dk = np.full(uk.size, cand.shape[1], dtype=np.int64)
        return cand, dk

    # -- chunked greedy routing ------------------------------------------------
    def _route_chunk(self, chunk_keys: np.ndarray,
                     loads: np.ndarray) -> np.ndarray:
        uk, inv, counts = np.unique(chunk_keys, return_inverse=True,
                                    return_counts=True)
        cand, dk = self._candidate_matrix(uk)
        lm = loads[cand]
        # pad columns beyond a key's choice count sort last (never selected:
        # occ % dk stays below dk)
        cols = np.arange(cand.shape[1], dtype=np.int64)
        lm[cols[None, :] >= dk[:, None]] = np.inf
        order = np.argsort(lm, axis=1, kind="stable")   # ties -> earlier hash
        ranked = np.take_along_axis(cand, order, axis=1)
        occ = _occurrence_index(inv, counts)
        dest = ranked[inv, occ % dk[inv]]
        loads += np.bincount(dest, minlength=loads.size).astype(np.float64)
        return dest

    def route(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, dtype=np.int64)
        out = np.empty(keys.size, dtype=np.int64)
        for lo in range(0, keys.size, self.chunk):
            hi = min(keys.size, lo + self.chunk)
            out[lo:hi] = self._route_chunk(keys[lo:hi], self._loads)
        return out


@register_strategy
class PartialKeyGrouping(ChoiceRouter):
    """PKG (Nasir et al., arXiv:1510.07623): two choices per key, every tuple
    to the less-loaded candidate. Splits each key over at most 2 workers —
    the head key's worker share drops from p1 (key grouping) to p1/2."""

    name = "pkg"


@register_strategy
class PowerOfBothChoices(ChoiceRouter):
    """Power of Both Choices (Nasir et al., arXiv:1504.00788): the same
    two-choice policy run *independently at each of S sources*, each source
    routing on its own local load estimate. ``n_sources=1`` is bit-identical
    to :class:`PartialKeyGrouping`."""

    name = "potc"

    def __init__(self, n_sources: int = 4, **kwargs):
        super().__init__(**kwargs)
        if n_sources < 1:
            raise ValueError("n_sources must be >= 1")
        self.n_sources = int(n_sources)
        self._src_loads = np.zeros((self.n_sources, 0), dtype=np.float64)
        self._pos = 0

    def bind(self, assignment: Assignment) -> None:
        super().bind(assignment)
        self._src_loads = np.zeros((self.n_sources, self.n_dest),
                                   dtype=np.float64)
        self._pos = 0

    @property
    def loads(self) -> np.ndarray:
        return self._src_loads.sum(axis=0)

    def route(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, dtype=np.int64)
        n = keys.size
        out = np.empty(n, dtype=np.int64)
        # tuples arrive round-robin at the S sources (position-deterministic
        # so repeated runs and parity oracles see the same split)
        src = (self._pos + np.arange(n, dtype=np.int64)) % self.n_sources
        for s in range(self.n_sources):
            idx = np.nonzero(src == s)[0]
            if not idx.size:
                continue
            sub = keys[idx]
            sub_out = np.empty(idx.size, dtype=np.int64)
            loads_s = self._src_loads[s]
            for lo in range(0, idx.size, self.chunk):
                hi = min(idx.size, lo + self.chunk)
                sub_out[lo:hi] = self._route_chunk(sub[lo:hi], loads_s)
            out[idx] = sub_out
        self._pos = int((self._pos + n) % self.n_sources)
        return out


@register_strategy
class WChoices(ChoiceRouter):
    """W-Choices (Nasir et al., "When Two Choices Are not Enough",
    arXiv:1510.05714): head keys — frequency share >= ``head_threshold`` in
    the last interval's stats — route over ALL W workers while the tail
    keeps PKG's two. The head set refreshes from the controller's step-1
    measurement each interval through the
    :class:`~repro_torch.core.balancer.sketch.SpaceSavingTracker` the
    sketch-mode planners use. The default ``head_capacity`` captures every
    key at or above the threshold share with a 4x margin. Before the first
    interval the head is empty and the router behaves exactly like PKG."""

    name = "wchoices"

    def __init__(self, head_threshold: float = 0.01,
                 head_capacity: Optional[int] = None, **kwargs):
        super().__init__(**kwargs)
        if not 0.0 < head_threshold <= 1.0:
            raise ValueError("head_threshold must be in (0, 1]")
        self.head_threshold = float(head_threshold)
        if head_capacity is None:
            head_capacity = max(4096, int(np.ceil(4.0 / self.head_threshold)))
        if head_capacity < 1:
            raise ValueError("head_capacity must be >= 1")
        self.head_capacity = int(head_capacity)
        self._head = np.zeros(0, dtype=np.int64)    # sorted head key ids

    def bind(self, assignment: Assignment) -> None:
        super().bind(assignment)
        self._head = np.zeros(0, dtype=np.int64)

    @property
    def head_keys(self) -> np.ndarray:
        return self._head

    def on_stats(self, stats: KeyStats) -> None:
        weight = stats.freq if stats.freq is not None else stats.cost
        total = float(weight.sum())
        if total <= 0.0:
            self._head = np.zeros(0, dtype=np.int64)
            return
        tracker = SpaceSavingTracker(self.head_capacity)
        tracker.update(stats.keys, weight)
        est = tracker.estimate(tracker.keys)    # upper bound: no head missed
        self._head = np.sort(
            tracker.keys[est >= self.head_threshold * tracker.total])

    def _candidate_matrix(self, uk: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray]:
        base = self.candidates(uk)
        d = base.shape[1]
        if not self._head.size or self.n_dest <= d:
            return base, np.full(uk.size, d, dtype=np.int64)
        pos = np.searchsorted(self._head, uk)
        pos = np.clip(pos, 0, self._head.size - 1)
        is_head = self._head[pos] == uk
        if not is_head.any():
            return base, np.full(uk.size, d, dtype=np.int64)
        cand = np.zeros((uk.size, self.n_dest), dtype=np.int64)
        cand[:, :d] = base
        cand[is_head] = np.arange(self.n_dest, dtype=np.int64)
        dk = np.where(is_head, self.n_dest, d).astype(np.int64)
        return cand, dk


class _AlgorithmsView(Mapping):
    """Deprecated read-only view of the registered table planners.

    Preserves the legacy ``ALGORITHMS`` dict surface (lookups, iteration,
    membership); every access warns. New code resolves through
    :func:`strategy_names` / :func:`resolve_strategy`, which also cover the
    choice routers this dict never could.
    """

    def __init__(self, backing: Dict[str, Callable]):
        self._backing = backing

    @staticmethod
    def _warn() -> None:
        warnings.warn(
            "repro_torch.core.balancer.ALGORITHMS is deprecated; use the "
            "strategy registry instead (repro_torch.core.balancer.strategy: "
            "strategy_names() / resolve_strategy()), which also exposes the "
            "choice routers (pkg/potc/wchoices)",
            DeprecationWarning, stacklevel=3)

    def __getitem__(self, name):
        self._warn()
        return self._backing[name]

    def __iter__(self):
        self._warn()
        return iter(self._backing)

    def __len__(self):
        self._warn()
        return len(self._backing)

    def __contains__(self, name):
        self._warn()
        return name in self._backing

    def __repr__(self):
        return f"ALGORITHMS({list(self._backing)})"


ALGORITHMS = _AlgorithmsView(PLANNERS)
