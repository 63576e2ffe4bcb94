"""xLSTM blocks (arXiv:2405.04517) — the JAX package's ``models/xlstm.py``:
the sLSTM (scalar memory, exponential gating) and the mLSTM (matrix
memory, attention-like).

The sLSTM is sequential by nature and runs as a time loop, one step per
token. The mLSTM runs chunkwise: within a chunk the matrix-memory readout
is a decay-masked attention-like product, across chunks the (B, H, Dh, Dh)
memory is carried sequentially. Both keep their cell arithmetic in float32
and share the per-token gates across heads, as the JAX package does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import dot
from .schema import ParamSpec


def _heads(cfg: ModelConfig):
    h = cfg.n_heads
    return h, cfg.d_model // h


def slstm_schema(cfg: ModelConfig, stack=()):
    st = tuple(["stack"] * len(stack))
    d = cfg.d_model
    return {
        "w_izfo": ParamSpec(stack + (d, 4 * d), st + ("embed", "mamba_inner")),
        "r_izfo": ParamSpec(stack + (d, 4 * d), st + ("embed", "mamba_inner"),
                            scale=0.05),
        "b_izfo": ParamSpec(stack + (4 * d,), st + ("mamba_inner",),
                            init="zeros"),
        "out": ParamSpec(stack + (d, d), st + ("mamba_inner", "embed")),
    }


def slstm(p, cfg: ModelConfig, x: torch.Tensor,
          state: Optional[dict] = None) -> Tuple[torch.Tensor, dict]:
    """Scalar-memory LSTM with exponential gating and a stabilizer state.

    state: {"c", "n", "m", "h"}, each (B, D) float32; None starts from
    zeros with the stabilizer m at -1e30 (a cache starts it at 0, as the
    JAX package's cache does)."""
    b, t, d = x.shape
    if state is None:
        zeros = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        state = {"c": zeros, "n": zeros, "m": zeros - 1e30, "h": zeros}
    wx = dot(x, p["w_izfo"])                                 # (B, T, 4D)
    s = state
    hs = []
    for i in range(t):
        rec = dot(s["h"].to(x.dtype), p["r_izfo"])
        z_i, z_z, z_f, z_o = torch.chunk(
            (wx[:, i] + rec + p["b_izfo"]).to(torch.float32), 4, dim=-1)
        f_log = F.logsigmoid(z_f)
        m_new = torch.maximum(f_log + s["m"], z_i)           # stabilizer
        i_g = torch.exp(z_i - m_new)
        f_g = torch.exp(f_log + s["m"] - m_new)
        c_new = f_g * s["c"] + i_g * torch.tanh(z_z)
        n_new = f_g * s["n"] + i_g
        h_new = torch.sigmoid(z_o) * c_new / torch.clamp(n_new, min=1e-6)
        s = {"c": c_new, "n": n_new, "m": m_new, "h": h_new}
        hs.append(h_new)
    out = torch.stack(hs, dim=1).to(x.dtype)                 # (B, T, D)
    return dot(out, p["out"]), s


def mlstm_schema(cfg: ModelConfig, stack=()):
    st = tuple(["stack"] * len(stack))
    d = cfg.d_model
    return {
        "wq": ParamSpec(stack + (d, d), st + ("embed", "q_heads")),
        "wk": ParamSpec(stack + (d, d), st + ("embed", "q_heads")),
        "wv": ParamSpec(stack + (d, d), st + ("embed", "q_heads")),
        "w_if": ParamSpec(stack + (d, 2), st + ("embed", None),
                          dtype=torch.float32),
        "b_if": ParamSpec(stack + (2,), st + (None,), init="zeros",
                          dtype=torch.float32),
        "out": ParamSpec(stack + (d, d), st + ("q_heads", "embed")),
    }


def _mlstm_chunk(s: dict, qc, kc, vc, ic, fc):
    """One chunk of c positions: (the new state, its outputs (B, c, H, Dh)).
    Gates are per-token scalars shared across heads."""
    c = qc.shape[1]
    fcum = torch.cumsum(fc, dim=1)                           # F_j (B, c)
    # intra-chunk decay: w[j, u] = exp(F_j - F_u + i_u) for u <= j
    decay = fcum[:, :, None] - fcum[:, None, :] + ic[:, None, :]
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=qc.device))
    decay = torch.where(mask[None], decay, -1e30)
    # per-position stabilizer: m_j = max(max_u decay[j, u], m_carry + F_j)
    m_pos = torch.maximum(decay.amax(dim=2), s["m"] + fcum)  # (B, c)
    w = torch.exp(decay - m_pos[:, :, None])                 # (B, c, c)
    carry_scale = torch.exp(s["m"] + fcum - m_pos)           # (B, c)
    logits = torch.einsum("bjhd,buhd->bhju", qc, kc)         # (B, H, c, c)
    weighted = logits * w[:, None]
    intra = torch.einsum("bhju,buhe->bjhe", weighted, vc)
    inter = torch.einsum("bjhd,bhde->bjhe", qc, s["C"])
    num = intra + inter * carry_scale[:, :, None, None]
    den_intra = weighted.sum(dim=3).transpose(1, 2)          # (B, c, H)
    den_inter = torch.einsum("bjhd,bhd->bjh", qc, s["n"])
    den = torch.abs(den_intra + den_inter * carry_scale[:, :, None])
    # floor at exp(-m): in true (unstabilized) scale this is max(|.|, 1),
    # making the output invariant to the chunking of the stabilizer
    floor = torch.exp(-m_pos)[:, :, None]
    out = num / torch.maximum(den, floor)[..., None]
    # end-of-chunk memory carry
    f_tot = fcum[:, -1:]                                     # (B, 1)
    tail = f_tot - fcum + ic                                 # (B, c)
    m_new = torch.maximum(s["m"] + f_tot, tail.amax(dim=1, keepdim=True))
    wk = torch.exp(tail - m_new)[:, :, None, None] * kc      # (B, c, H, Dh)
    c_upd = torch.einsum("buhd,buhe->bhde", wk, vc)
    n_upd = wk.sum(dim=1)
    scale_old = torch.exp(s["m"] + f_tot - m_new)            # (B, 1)
    return {"C": s["C"] * scale_old[:, :, None, None] + c_upd,
            "n": s["n"] * scale_old[:, :, None] + n_upd,
            "m": m_new}, out


def mlstm(p, cfg: ModelConfig, x: torch.Tensor,
          state: Optional[dict] = None, chunk: int = 128
          ) -> Tuple[torch.Tensor, dict]:
    """Matrix-memory LSTM, chunkwise-parallel.

    state: {"C": (B, H, Dh, Dh), "n": (B, H, Dh), "m": (B, 1)}, float32
    (m is shared across heads). Chunks of ``chunk`` positions, or the
    largest count below it that divides T."""
    b, t, d = x.shape
    h, dh = _heads(cfg)
    if state is None:
        f32 = dict(dtype=torch.float32, device=x.device)
        state = {"C": torch.zeros((b, h, dh, dh), **f32),
                 "n": torch.zeros((b, h, dh), **f32),
                 "m": torch.zeros((b, 1), **f32)}
    # f32 cell arithmetic: exponential gating amplifies bf16 rounding into
    # chunking-dependent outputs
    q = dot(x, p["wq"]).reshape(b, t, h, dh).to(torch.float32)
    k = dot(x, p["wk"]).reshape(b, t, h, dh).to(torch.float32) / (dh ** 0.5)
    v = dot(x, p["wv"]).reshape(b, t, h, dh).to(torch.float32)
    if_log = dot(x.to(torch.float32), p["w_if"]) + p["b_if"]
    i_log = if_log[..., 0]                                   # (B, T)
    f_log = F.logsigmoid(if_log[..., 1])                     # (B, T)

    c = min(chunk, t)
    while t % c:
        c -= 1
    s = state
    outs = []
    for c0 in range(0, t, c):
        sl = slice(c0, c0 + c)
        s, out = _mlstm_chunk(s, q[:, sl], k[:, sl], v[:, sl], i_log[:, sl],
                              f_log[:, sl])
        outs.append(out)
    out = torch.cat(outs, dim=1).reshape(b, t, h * dh).to(x.dtype)
    return dot(out, p["out"]), s
