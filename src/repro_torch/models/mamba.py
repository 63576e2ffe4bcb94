"""Mamba (S6) block for the jamba hybrid — the JAX package's
``models/mamba.py``.

The scan h_t = a_t h_{t-1} + bx_t runs as there: time is cut into chunks,
each chunk is scanned in log depth over its time axis (torch ops, with the
JAX package's combine ``(al ar, br + ar bl)`` and ``lax.associative_scan``'s
odd/even recursion), and the (B, D_in, N) state is carried across the
chunks sequentially. A decode step (T = 1) updates the
carried state directly. The state is always returned: a prefill hands it to
the decode loop, a training step drops it.

The JAX package computes this scan in XLA, not in a Pallas kernel, so it is
torch ops here too (ROADMAP B7 keeps a hand-written scan kernel queued).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import dot
from .schema import ParamSpec


def mamba_schema(cfg: ModelConfig, stack=()):
    st = tuple(["stack"] * len(stack))
    d = cfg.d_model
    di = cfg.mamba_expand * d
    n = cfg.mamba_d_state
    dc = cfg.mamba_d_conv
    dt_rank = max(1, d // 16)
    return {
        "in_proj": ParamSpec(stack + (d, 2 * di),
                             st + ("embed", "mamba_inner")),
        "conv_w": ParamSpec(stack + (dc, di), st + ("conv", "mamba_inner"),
                            scale=0.5),
        "conv_b": ParamSpec(stack + (di,), st + ("mamba_inner",),
                            init="zeros"),
        "x_proj": ParamSpec(stack + (di, dt_rank + 2 * n),
                            st + ("mamba_inner", None)),
        "dt_proj": ParamSpec(stack + (dt_rank, di), st + (None, "mamba_inner"),
                             scale=0.1),
        "dt_bias": ParamSpec(stack + (di,), st + ("mamba_inner",),
                             init="zeros"),
        "a_log": ParamSpec(stack + (di, n), st + ("mamba_inner", None),
                           init="ones", dtype=torch.float32),
        "d_skip": ParamSpec(stack + (di,), st + ("mamba_inner",), init="ones",
                            dtype=torch.float32),
        "out_proj": ParamSpec(stack + (di, d), st + ("mamba_inner", "embed")),
    }


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` op for op, ``x * (1 / (1 + exp(-x)))``: in bfloat16
    each op rounds, as XLA's are, where ``F.silu`` rounds once."""
    return x * (1 / (1 + torch.exp(-x)))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` op for op, ``max(x, 0) + log1p(exp(-|x|))``."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def _combine(left, right):
    """The scan's operator: ``(al, bl), (ar, br) -> (al ar, br + ar bl)``."""
    (al, bl), (ar, br) = left, right
    return al * ar, torch.addcmul(br, ar, bl)


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """``even[0], odd[0], even[1], ...`` along dim 1 (``even`` is as long as
    ``odd`` or one longer)."""
    n = even.shape[1] + odd.shape[1]
    if odd.shape[1] < even.shape[1]:
        odd = torch.cat([odd, even[:, -1:]], dim=1)
    return torch.stack([even, odd], dim=2).flatten(1, 2)[:, :n]


def _scan_in_chunk(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan over dim 1 of (a, b) under :func:`_combine`, in log
    depth and O(T) work: ``lax.associative_scan``'s recursion (combine
    adjacent pairs, scan the half, then fill in the even positions)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd_a, odd_b = _scan_in_chunk(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]),
                                            (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        even = _combine((odd_a[:, :-1], odd_b[:, :-1]),
                        (a[:, 2::2], b[:, 2::2]))
    else:
        even = _combine((odd_a, odd_b), (a[:, 2::2], b[:, 2::2]))
    even_a = torch.cat([a[:, :1], even[0]], dim=1)
    even_b = torch.cat([b[:, :1], even[1]], dim=1)
    return _interleave(even_a, odd_a), _interleave(even_b, odd_b)


def _ssm_scan_chunked(a: torch.Tensor, bx: torch.Tensor, h0: torch.Tensor,
                      chunk: int):
    """h_t = a_t * h_{t-1} + bx_t over time, chunked.

    a, bx: (B, T, Di, N); h0: (B, Di, N). Returns (h_all (B, T, Di, N),
    h_T). One chunk's transient scan tensors exist at a time."""
    t = a.shape[1]
    if t % chunk:
        raise ValueError(f"T={t} is not a multiple of the chunk {chunk}")
    h = h0
    outs = []
    for c0 in range(0, t, chunk):
        a_pref, bx_pref = _scan_in_chunk(a[:, c0:c0 + chunk],
                                         bx[:, c0:c0 + chunk])
        outs.append(a_pref * h[:, None] + bx_pref)
        h = a_pref[:, -1] * h + bx_pref[:, -1]
    return torch.cat(outs, dim=1), h


def mamba(p, cfg: ModelConfig, x: torch.Tensor,
          state: Optional[dict] = None, chunk: int = 256
          ) -> Tuple[torch.Tensor, dict]:
    """x: (B, T, D). state (decode): {"h": (B, Di, N), "conv": (B, dc-1, Di)}.

    Training/prefill: state=None (a zero state), full-sequence chunked scan.
    Decode: T small (usually 1), from the carried state. Returns (out
    (B, T, D), the new state)."""
    b, t, d = x.shape
    di = cfg.mamba_expand * d
    n = cfg.mamba_d_state
    dc = cfg.mamba_d_conv
    dt_rank = max(1, d // 16)

    xs, z = torch.chunk(dot(x, p["in_proj"]), 2, dim=-1)     # (B, T, Di)

    # causal depthwise conv over time
    if state is not None:
        conv_in = torch.cat([state["conv"], xs], dim=1)  # promotes
    else:
        conv_in = F.pad(xs, (0, 0, dc - 1, 0))
    new_conv = conv_in[:, -(dc - 1):, :]
    windows = torch.stack([conv_in[:, i:i + t, :] for i in range(dc)], dim=2)
    conv_w = p["conv_w"]
    if windows.dtype != conv_w.dtype:
        dt_ = torch.promote_types(windows.dtype, conv_w.dtype)
        windows, conv_w = windows.to(dt_), conv_w.to(dt_)
    xs = torch.einsum("btcd,cd->btd", windows, conv_w) + p["conv_b"]
    xs = _silu(xs)

    proj = dot(xs, p["x_proj"])
    dt_low, b_in, c_in = torch.split(proj, [dt_rank, n, n], dim=-1)
    dt = _softplus(dot(dt_low, p["dt_proj"]) + p["dt_bias"])   # (B, T, Di)
    a = -torch.exp(p["a_log"].to(torch.float32))                 # (Di, N)
    # discretize: a_bar = exp(dt * A); b_bar x = dt * B * x
    dt32 = dt.to(torch.float32)
    a_bar = torch.exp(dt32[..., None] * a)                       # (B,T,Di,N)
    bx = (dt32 * xs.to(torch.float32))[..., None] * \
        b_in.to(torch.float32)[:, :, None, :]                    # (B,T,Di,N)

    h0 = (state["h"] if state is not None
          else torch.zeros((b, di, n), dtype=torch.float32, device=x.device))
    if t == 1:
        h_t = a_bar[:, 0] * h0 + bx[:, 0]
        h_all = h_t[:, None]
    else:
        c = min(chunk, t)
        while t % c:                  # largest divisor of t that is <= chunk
            c -= 1
        h_all, h_t = _ssm_scan_chunked(a_bar, bx, h0, c)

    y = torch.einsum("btdn,btn->btd", h_all, c_in.to(torch.float32))
    y = y + p["d_skip"] * xs.to(torch.float32)
    y = y.to(x.dtype) * _silu(z)
    return dot(y, p["out_proj"]), {"h": h_t, "conv": new_conv}
