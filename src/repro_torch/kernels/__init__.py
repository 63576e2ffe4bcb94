"""The port's kernels: hand-written CUDA C++ for Hopper (``csrc/``), each
beside its plain PyTorch version.

* :mod:`.routing_lookup` — F(k) routing (paper Eq. 1);
* :mod:`.key_stats` — step-1 per-key frequency and cost;
* :mod:`.ref` — plain versions of the JAX package's oracles.

Importing this package builds nothing: each kernel compiles with ``nvcc`` at
its first launch (:mod:`._build`).
"""

from .key_stats import key_stats, key_stats_plain
from .routing_lookup import (RoutingTable, route_keys, route_plain,
                             routing_lookup)

__all__ = ["key_stats", "key_stats_plain", "RoutingTable", "route_keys",
           "route_plain", "routing_lookup"]
