"""Skew-shield balancer: the paper's table planners on the host.

A numpy copy of the JAX package's control plane. Algorithms (paper Sec.
III): simple, mintable, minmig, mixed, mixed_bf; the readj baseline; the
compact Mixed with HLHE discretization (Sec. IV); the scalar reference
planners kept as parity oracles; and the count-min/SpaceSaving sketch that
feeds the planners a head-only snapshot in sketch mode. Every planner is
resolvable by name through the registry in :mod:`.strategy`. The per-tuple
choice routers (PKG, Power of Both Choices, W-Choices) are not ported yet.
"""

from . import metrics
from .compact import build_groups, build_groups_indexed, compact_mixed
from .discretize import discretize, hlhe_representatives, total_deviation
from .hashing import GOLDEN_SEED_STRIDE, Hash32, fmix32
from .llfd import PlannerContext, Workspace
from .minmig import minmig
from .mintable import mintable
from .mixed import mixed, mixed_bf
from .readj import readj, readj_best_sigma
from .reference import (REFERENCE_ALGORITHMS, reference_minmig,
                        reference_mintable, reference_mixed,
                        reference_mixed_bf)
from .simple import simple
from .sketch import (CountMinSketch, SketchConfig, SketchStats,
                     SpaceSavingTracker)
from .strategy import (PartitionStrategy, TablePlanner, register_planner,
                       register_strategy, resolve_strategy, strategy_names)
from .types import (Assignment, BalanceConfig, HashRouter, KeyStats,
                    RebalanceResult)

for _name, _fn in (
    ("simple", simple),
    ("mintable", mintable),
    ("minmig", minmig),
    ("mixed", mixed),
    ("mixed_bf", mixed_bf),
    ("readj", readj),
    ("compact_mixed", compact_mixed),
    # scalar planners, kept as parity oracles / A-B baselines
    ("mixed_reference", reference_mixed),
    ("mintable_reference", reference_mintable),
    ("minmig_reference", reference_minmig),
):
    register_planner(_name, _fn)
del _name, _fn

__all__ = [
    "Assignment", "BalanceConfig", "KeyStats", "RebalanceResult", "HashRouter",
    "GOLDEN_SEED_STRIDE", "Hash32", "fmix32", "metrics",
    "PlannerContext", "Workspace",
    "simple", "mintable", "minmig", "mixed", "mixed_bf",
    "readj", "readj_best_sigma",
    "compact_mixed", "build_groups", "build_groups_indexed", "discretize",
    "hlhe_representatives", "total_deviation", "REFERENCE_ALGORITHMS",
    "reference_mintable", "reference_minmig", "reference_mixed",
    "reference_mixed_bf",
    "CountMinSketch", "SketchConfig", "SketchStats", "SpaceSavingTracker",
    "PartitionStrategy", "TablePlanner", "register_planner",
    "register_strategy", "resolve_strategy", "strategy_names",
]
