"""GQA attention with RoPE, sliding windows, a KV cache and the flash kernel
— the JAX package's ``models/attention.py``.

The KV cache is stored flattened, (B, S_max, Hkv*Dh) per layer, as in the
JAX package. Unlike JAX's functional update, a cached step writes its K/V
into the cache tensors in place (the cache of a 12B model is gigabytes, and
a copy per layer per decode step would double its traffic) and returns the
same tensors.

``REPRO_PERF_WINDOW_SLICE`` (:func:`_xla_attention`) sends a cache-free
sliding-window layer's query chunks to their key band only, as the JAX
package's flag does. ``REPRO_PERF_ATTN_SHARD`` (the ("dp", "tp") pins on q,
k and v) is read by the mesh layer body, ``models.transformer``. Not
ported: the dry run's ``unrolled_chunks`` probe, an XLA cost-analysis
tool (the port's FLOP counter sees every chunk of the loop).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .. import flags
from ..kernels import attention as flash_attention
from .config import ModelConfig
from .layers import dot, rope
from .schema import ParamSpec

NEG_INF = -1e30


def attn_schema(cfg: ModelConfig, stack=(), cross: bool = False):
    st = tuple(["stack"] * len(stack))
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    sch = {
        "wq": ParamSpec(stack + (d, hq * dh), st + ("embed", "q_heads")),
        "wk": ParamSpec(stack + (d, hkv * dh), st + ("embed", "kv_flat")),
        "wv": ParamSpec(stack + (d, hkv * dh), st + ("embed", "kv_flat")),
        "wo": ParamSpec(stack + (hq * dh, d), st + ("q_heads", "embed")),
    }
    if cfg.qkv_bias and not cross:
        sch["bq"] = ParamSpec(stack + (hq * dh,), st + ("q_heads",),
                              init="zeros")
        sch["bk"] = ParamSpec(stack + (hkv * dh,), st + ("kv_flat",),
                              init="zeros")
        sch["bv"] = ParamSpec(stack + (hkv * dh,), st + ("kv_flat",),
                              init="zeros")
    return sch


def _split_heads(x: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    b, t, _ = x.shape
    return x.reshape(b, t, n, dh)


def _attention_block(q, k, v, *, causal: bool, window: int, q_positions,
                     kv_valid_len) -> torch.Tensor:
    """Plain attention (B,H,T,Dh) x (B,Hkv,S,Dh); GQA via reshape-grouping.
    Masked scores are -1e30, as in the JAX package's jnp path."""
    b, hq, t, dh = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, t, dh)
    logits = torch.einsum("bkgtd,bksd->bkgts", qg.to(torch.float32),
                          k.to(torch.float32)) * (dh ** -0.5)
    k_pos = torch.arange(s, device=q.device)[None, :]
    q_pos = q_positions[:, :, None] if q_positions.dim() == 2 else \
        q_positions[None, :, None]
    if kv_valid_len is not None:
        mask = (k_pos[None] < kv_valid_len).expand(b, t, s)
    else:
        mask = torch.ones((1, t, s), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos[None] <= q_pos)
    if window > 0:
        mask = mask & (k_pos[None] > q_pos - window)
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgts,bksd->bkgtd", probs, v.to(torch.float32))
    return out.reshape(b, hq, t, dh).to(q.dtype)


_CHUNK_ELEMS = 2 ** 21        # materialize at most ~2M (T x S) scores / head


def _xla_attention(q, k, v, *, causal: bool, window: int, q_positions,
                   kv_valid_len) -> torch.Tensor:
    """Query-chunked plain attention: never materializes the full (T, S)
    score matrix — the JAX package's pre-flash path, chunked the same way
    (its ``lax.scan`` over chunks is a loop here).

    With ``REPRO_PERF_WINDOW_SLICE`` set, a causal sliding-window call
    without a cache (``kv_valid_len`` None, T = S) is always chunked, and
    where ``window + chunk < S`` each query chunk attends over its key band
    ``[chunk_start - window, chunk_end)`` only, the band's start clipped to
    ``[0, S - (window + chunk)]``: the keys outside the band are the ones
    the window masks, so the function is the same."""
    t = q.shape[2]
    s = k.shape[2]
    window_slice = (flags.enabled("WINDOW_SLICE") and causal and window > 0
                    and kv_valid_len is None and t == s)
    if not window_slice and (t * s <= _CHUNK_ELEMS or t <= 128):
        return _attention_block(q, k, v, causal=causal, window=window,
                                q_positions=q_positions,
                                kv_valid_len=kv_valid_len)
    chunk = min(max(128, _CHUNK_ELEMS // s), t)
    while t % chunk:
        chunk -= 1
    band = window + chunk if window_slice and window + chunk < s else None
    outs = []
    for c0 in range(0, t, chunk):
        pos = q_positions[..., c0:c0 + chunk]
        if band is None:
            kc, vc = k, v
        else:
            start = min(max(c0 - window, 0), s - band)
            kc, vc = k[:, :, start:start + band], v[:, :, start:start + band]
            pos = pos - start
        outs.append(_attention_block(
            q[:, :, c0:c0 + chunk], kc, vc, causal=causal, window=window,
            q_positions=pos, kv_valid_len=kv_valid_len))
    return torch.cat(outs, dim=2)


def attn(p, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
         window: int = 0, causal: bool = True,
         cache: Optional[dict] = None, cache_index: int = 0,
         kv_source: Optional[torch.Tensor] = None, use_rope: bool = True,
         use_flash: bool = False, kv_heads: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Self- or cross-attention over ``x`` (B, T, D) at ``positions``.

    cache: {"k": (B, S_max, Hkv*Dh), "v": ...} — the step writes its K/V at
    ``cache_index`` (in place) and attends over ``[0, cache_index + T)``
    through the plain path. Without a cache, ``use_flash`` sends causal
    self-attention to the flash kernel. ``kv_source`` (B, S, D), the
    encoder output, makes it cross-attention: K and V come from it, with no
    RoPE and no cache, and never through the flash kernel (the JAX
    package's rule); the caller passes ``causal=False``.

    ``kv_heads`` (one KV head index per query head) picks each query
    head's K/V after the cache: a tensor-parallel rank that holds some of
    the query heads but all the KV heads (``models.transformer``).
    """
    src = x if kv_source is None else kv_source
    return attend(p, cfg, dot(x, p["wq"]), dot(src, p["wk"]),
                  dot(src, p["wv"]), positions, window=window, causal=causal,
                  cache=cache, cache_index=cache_index,
                  cross=kv_source is not None, use_rope=use_rope,
                  use_flash=use_flash, kv_heads=kv_heads)


def attend(p, cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor, positions: torch.Tensor, window: int = 0,
           causal: bool = True, cache: Optional[dict] = None,
           cache_index: int = 0, cross: bool = False, use_rope: bool = True,
           use_flash: bool = False, kv_heads: Optional[torch.Tensor] = None,
           pin: Optional[Callable] = None
           ) -> Tuple[torch.Tensor, Optional[dict]]:
    """:func:`attn` from the projections ``q`` (B, T, Hq*Dh), ``k`` and
    ``v`` (B, S, Hkv*Dh) on: the biases, RoPE, the cache, the attention
    and the output projection (``cross``: K/V from an encoder)."""
    out, new_cache = attend_heads(
        p, cfg, q, k, v, positions, window=window, causal=causal,
        cache=cache, cache_index=cache_index, cross=cross,
        use_rope=use_rope, use_flash=use_flash, kv_heads=kv_heads, pin=pin)
    return dot(out, p["wo"]), new_cache


def attend_heads(p, cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, positions: torch.Tensor, window: int = 0,
                 causal: bool = True, cache: Optional[dict] = None,
                 cache_index: int = 0, cross: bool = False,
                 use_rope: bool = True, use_flash: bool = False,
                 kv_heads: Optional[torch.Tensor] = None,
                 pin: Optional[Callable] = None
                 ) -> Tuple[torch.Tensor, Optional[dict]]:
    """:func:`attend` before the output projection: the heads' outputs
    (B, T, Hq*Dh). ``pin`` (``REPRO_PERF_ATTN_SHARD``'s layout check of
    the mesh layer body) takes and returns the (B, H, S, Dh) q, k and v
    where the JAX package pins them."""
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    b, t, _ = q.shape
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    qh = _split_heads(q, hq, dh)
    kh = _split_heads(k, hkv, dh)
    if use_rope and not cross:
        qh = rope(qh, positions, cfg.rope_theta)
        kh = rope(kh, positions, cfg.rope_theta)
    qt = qh.transpose(1, 2)

    new_cache = None
    if cache is not None:
        idx = int(cache_index)
        cache["k"][:, idx:idx + t] = kh.reshape(b, t, hkv * dh)
        cache["v"][:, idx:idx + t] = v
        new_cache = cache
        k_full = cache["k"].reshape(b, -1, hkv, dh).transpose(1, 2)
        v_full = cache["v"].reshape(b, -1, hkv, dh).transpose(1, 2)
        if pin is not None:
            qt, k_full, v_full = pin(qt, k_full, v_full)
        if kv_heads is not None:
            k_full, v_full = k_full[:, kv_heads], v_full[:, kv_heads]
        out = _xla_attention(qt, k_full, v_full, causal=True, window=window,
                             q_positions=positions, kv_valid_len=idx + t)
    else:
        k_full = kh.transpose(1, 2)
        v_full = _split_heads(v, hkv, dh).transpose(1, 2)
        if pin is not None:
            qt, k_full, v_full = pin(qt, k_full, v_full)
        if kv_heads is not None:
            k_full, v_full = k_full[:, kv_heads], v_full[:, kv_heads]
        if use_flash and causal and not cross:
            out = flash_attention(qt, k_full, v_full, causal=True,
                                  window=window)
        else:
            out = _xla_attention(qt, k_full, v_full, causal=causal,
                                 window=window, q_positions=positions,
                                 kv_valid_len=None)
    return out.transpose(1, 2).reshape(b, t, hq * dh), new_cache
