"""The port's kernels: hand-written CUDA C++ for Hopper (``csrc/``), each
beside its plain PyTorch version.

* :mod:`.routing_lookup` — F(k) routing (paper Eq. 1);
* :mod:`.key_stats` — step-1 per-key frequency and cost;
* :mod:`.flash_attention` — blocked causal / sliding-window GQA attention;
* :mod:`.ops` — the JAX package's entry-point names: ``fused_key_stats``,
  ``mixed_route`` and the model's ``attention``;
* :mod:`.ref` — plain versions of the JAX package's oracles.

Importing this package builds nothing: each kernel compiles with ``nvcc`` at
its first launch (:mod:`._build`).
"""

from .flash_attention import flash_attention, flash_attention_plain
from .key_stats import key_stats, key_stats_plain
from .ops import attention, fused_key_stats, mixed_route
from .routing_lookup import (RoutingTable, route_keys, route_plain,
                             routing_lookup)

__all__ = ["attention", "fused_key_stats", "mixed_route",
           "flash_attention", "flash_attention_plain",
           "key_stats", "key_stats_plain", "RoutingTable", "route_keys",
           "route_plain", "routing_lookup"]
