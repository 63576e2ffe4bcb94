"""Partitioning strategies: one protocol over interval planners.

The paper's table planners solve a per-interval optimization producing a new
assignment function F' (routing table + hash) and a migration plan — every
tuple of a key goes to F(k), state moves when F changes. They sit behind the
:class:`PartitionStrategy` protocol and a registry: strategies are
*registered*, not if/elif'd — :func:`register_strategy` +
:func:`strategy_names` + :func:`resolve_strategy`.

One ``algorithm=`` spec grammar (the controller and ``KeyedStage`` accept
exactly this and delegate here):

* a **name** from :func:`strategy_names` — resolved to a fresh instance;
* a **callable** ``(stats, assignment, config) -> RebalanceResult`` — the
  planner signature, wrapped as a :class:`TablePlanner`;
* a **configured** :class:`PartitionStrategy` **instance** — used as-is.

Every table planner the JAX package registers is registered here too
(``balancer/__init__.py``); the choice routers (PKG, Power of Both Choices,
W-Choices) are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

from .types import Assignment, BalanceConfig, KeyStats, RebalanceResult

#: name -> zero-arg factory returning a fresh strategy instance. Mutated only
#: through :func:`register_strategy` / :func:`register_planner`.
STRATEGIES: Dict[str, Callable[[], "PartitionStrategy"]] = {}


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

    Names yield a *fresh* instance per call; instances pass through
    unchanged; bare callables with the planner signature are wrapped in a
    :class:`TablePlanner` (``name`` taken from ``__name__``).
    """
    if isinstance(spec, PartitionStrategy):
        return spec
    if callable(spec):
        return TablePlanner(spec)
    return get_strategy(spec)()


class PartitionStrategy:
    """Protocol for partitioning strategies.

    * ``name`` — registry key / ``algorithm_name`` surfaced by controllers.
    * ``kind`` — ``"planner"`` or ``"router"``.

    The controller calls :meth:`bind` once with its assignment; planners then
    serve :meth:`plan` per triggered interval. Choice routers (``kind ==
    "router"``) are not ported yet, and the controller refuses them.
    """

    name: str = ""
    kind: str = "planner"

    @property
    def is_router(self) -> bool:
        return self.kind == "router"

    def bind(self, assignment: Assignment) -> None:
        """Attach to a controller's assignment (called once per controller)."""

    def plan(self, stats: KeyStats, assignment: Assignment,
             config: BalanceConfig) -> RebalanceResult:
        raise NotImplementedError(f"{self.name!r} is not a table planner")


class TablePlanner(PartitionStrategy):
    """A paper-family interval planner behind the strategy protocol: wraps
    the ``(stats, assignment, config) -> RebalanceResult`` callable."""

    kind = "planner"

    def __init__(self, fn, name: Optional[str] = None):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "custom")

    def plan(self, stats, assignment, config) -> RebalanceResult:
        return self.fn(stats, assignment, config)


def register_planner(name: str, fn) -> None:
    """Register a planner callable under ``name`` as a :class:`TablePlanner`."""
    STRATEGIES[name] = lambda fn=fn, name=name: TablePlanner(fn, name)
