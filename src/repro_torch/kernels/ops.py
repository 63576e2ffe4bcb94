"""The model's attention entry point, as the JAX package's
``kernels/ops.attention``.

Non-causal full attention (no mask at all) goes to the plain version, as
the JAX package sends it to its jnp oracle; every masked case goes to the
flash kernel (:func:`~repro_torch.kernels.flash_attention.flash_attention`),
which runs its own plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from .flash_attention import flash_attention, flash_attention_plain


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: int = 0) -> torch.Tensor:
    """Blocked causal/sliding-window GQA attention; q (B, Hq, T, D), k and v
    (B, Hkv, S, D)."""
    if not causal and window <= 0:
        return flash_attention_plain(q, k, v, causal=False, window=0)
    return flash_attention(q, k, v, causal=causal, window=window)
