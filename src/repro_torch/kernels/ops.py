"""Public entry points over the port's kernels, as the JAX package's
``kernels/ops.py`` names them.

* :func:`fused_key_stats` — g(k), c(k) for one interval's stream through
  the ``key_stats`` kernel (paper Fig. 5 step 1);
* :func:`mixed_route` — F(k) (paper Eq. 1) against a raw override table
  through the routing kernel;
* :func:`attention` — the model's attention: non-causal full attention (no
  mask at all) goes to the plain version, as the JAX package sends it to
  its jnp oracle; every masked case goes to the flash kernel
  (:func:`~repro_torch.kernels.flash_attention.flash_attention`).

Each wrapper runs its kernel's plain version for CPU tensors and launches
the kernel for CUDA tensors; the JAX package's ``interpret=`` flag (Pallas
interpret mode) has no counterpart.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention, flash_attention_plain
from .key_stats import key_stats
from .routing_lookup import routing_lookup


def fused_key_stats(keys: torch.Tensor, costs: Optional[torch.Tensor],
                    num_keys: int):
    """g(k), c(k) for one interval's stream (paper Fig. 5 step 1): int32
    keys, costs of any float dtype (None = unit cost). Returns ``(freq,
    cost)``, each (num_keys,) float32."""
    if costs is None:
        costs = torch.ones(keys.shape, dtype=torch.float32,
                           device=keys.device)
    return key_stats(keys, costs, num_keys)


def mixed_route(keys: torch.Tensor, table_keys: torch.Tensor,
                table_dests: torch.Tensor, n_dest: int,
                seed: int = 0) -> torch.Tensor:
    """F(k) per paper Eq. 1: the override table's dest, else
    ``fmix32(k ^ seed) mod n_dest``. int32 in and out; -1 marks an empty
    table slot."""
    return routing_lookup(keys, table_keys, table_dests, n_dest, seed=seed)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """Blocked causal/sliding-window GQA attention; q (B, Hq, T, D), k and v
    (B, Hkv, S, D)."""
    if not causal and window <= 0:
        return flash_attention_plain(q, k, v, causal=False, window=0)
    return flash_attention(q, k, v, causal=causal, window=window)
