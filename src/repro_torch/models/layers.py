"""Shared building blocks: RMSNorm, RoPE, gated MLP, embeddings — the JAX
package's ``models/layers.py``, with the same float32 arithmetic and casts
back to the input's dtype."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .schema import ParamSpec


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
    gate = F.silu(x @ p["w_gate"])
    up = x @ p["w_up"]
    return (gate * up) @ p["w_down"]


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
    return p["tokens"][tokens]


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"]
