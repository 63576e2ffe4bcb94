"""Shared building blocks: RMSNorm, RoPE, gated MLP, embeddings — the JAX
package's ``models/layers.py``, with the same float32 arithmetic and casts
back to the input's dtype. A product of a bfloat16 activation and a float32
weight runs in float32 (:func:`dot`), as ``jnp.einsum`` promotes it."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .schema import ParamSpec


def dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two (torch's ``matmul`` takes
    one dtype; ``jnp.einsum`` promotes a bfloat16 x float32 product to
    float32). Operands of one dtype go straight to ``@``."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


# ------------------------------------------------------------------ norm --
def rmsnorm_schema(d: int, stack=()):
    return {"scale": ParamSpec(stack + (d,), tuple(["stack"] * len(stack)) +
                               ("embed",), init="ones", dtype=torch.float32)}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    h = x.to(torch.float32)
    var = torch.mean(h * h, dim=-1, keepdim=True)
    return (h * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


# ------------------------------------------------------------------ rope --
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (B, T, H, Dh) with positions (B, T) or (T,)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].to(torch.float32) * freqs  # (B, T, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------- mlp --
def mlp_schema(cfg: ModelConfig, stack=()):
    st = tuple(["stack"] * len(stack))
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamSpec(stack + (d, f), st + ("embed", "mlp")),
        "w_up": ParamSpec(stack + (d, f), st + ("embed", "mlp")),
        "w_down": ParamSpec(stack + (f, d), st + ("mlp", "embed")),
    }


def mlp(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU feed-forward."""
    gate = F.silu(dot(x, p["w_gate"]))
    up = dot(x, p["w_up"])
    return dot(gate * up, p["w_down"])


# ------------------------------------------------------------- embedding --
def embed_schema(cfg: ModelConfig):
    return {
        # 1/sqrt(d) init: harmless for the forward pass (RMSNorm follows) and
        # keeps tied-unembedding logits at unit scale.
        "tokens": ParamSpec((cfg.vocab_padded, cfg.d_model),
                            ("vocab", "embed"), scale=cfg.d_model ** -0.5),
    }


def unembed_schema(cfg: ModelConfig):
    return {"w": ParamSpec((cfg.d_model, cfg.vocab_padded),
                           ("embed", "vocab"))}


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    # F.embedding, not ``p["tokens"][tokens]``: the gather's own backward
    # adds a repeated token's rows with atomic float adds on the CPU, in an
    # order that changes from call to call
    return F.embedding(tokens, p["tokens"])


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    return dot(x, p["w"])
