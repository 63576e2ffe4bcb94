"""Composable LM assembler for all ten archs — the JAX package's
``models/transformer.py``.

Layers are grouped into *superblocks* of ``cfg.layer_pattern`` length with
stacked parameters (leading ``n_groups`` dim), as in the JAX package, so a
parameter tree converts one-to-one; the JAX package's ``lax.scan`` over the
groups is a Python loop here, over ``unbind`` views of the stacked leaves
(so autograd hands each stacked leaf one gradient, the stack of its
groups'). Layer kinds inside a superblock: attn | mamba | slstm | mlstm,
each optionally followed by cross-attention to an encoder output (whisper)
and by a dense or MoE MLP. The same forward serves training and a
cache-free step (cache=None), prefill (cache + index 0, T = prompt) and
decode (cache + index t, T = 1); a step with a cache updates it in place
(the attention K/V planes and the recurrent layers' states alike).

Front ends: ``encode`` is the whisper encoder over stub frame embeddings
(sinusoidal positions, non-causal plain attention); a vision prefix
(``pixel_embeds``) is prepended to the token embeddings, and
:func:`lm_loss` drops it before the loss.

Training: :func:`lm_loss` is the next-token cross-entropy with the logits
made one sequence chunk at a time. ``remat`` recomputes each superblock in
the backward pass, keeping only the outputs of the plain 2-D products
(``aten.mm``/``aten.addmm``): the JAX package's ``jax.checkpoint`` with
``dots_with_no_batch_dims_saveable``, so the experts' batched products
(``bmm``) are recomputed, as there. It also keeps the outputs of the MoE
router's ``topk`` (values and indices), so the recompute dispatches every
token exactly as the forward did: a last-bit difference in a recomputed
router logit at a near-tie would otherwise send a token to another expert
and differentiate another routing than the loss's. In exact arithmetic
this computes the same function.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from . import attention as attn_mod
from . import layers
from . import mamba as mamba_mod
from . import moe as moe_mod
from . import xlstm as xlstm_mod
from .config import ModelConfig
from .schema import ParamSpec, tree_map

PyTree = Any


# ------------------------------------------------------------------ schema --
def _sub_schema(cfg: ModelConfig, j: int, n_groups: int, cross: bool):
    kind = cfg.layer_pattern[j]
    stack = (n_groups,)
    sch: Dict[str, Any] = {"norm": layers.rmsnorm_schema(cfg.d_model, stack)}
    if kind == "attn":
        sch["attn"] = attn_mod.attn_schema(cfg, stack)
    elif kind == "mamba":
        sch["mamba"] = mamba_mod.mamba_schema(cfg, stack)
    elif kind == "slstm":
        sch["cell"] = xlstm_mod.slstm_schema(cfg, stack)
    elif kind == "mlstm":
        sch["cell"] = xlstm_mod.mlstm_schema(cfg, stack)
    else:
        raise ValueError(kind)
    if cross:
        sch["cross_norm"] = layers.rmsnorm_schema(cfg.d_model, stack)
        sch["cross"] = attn_mod.attn_schema(cfg, stack, cross=True)
    if cfg.d_ff > 0:
        sch["mlp_norm"] = layers.rmsnorm_schema(cfg.d_model, stack)
        if cfg.layer_is_moe(j):
            sch["moe"] = moe_mod.moe_schema(cfg, stack)
        else:
            sch["mlp"] = layers.mlp_schema(cfg, stack)
    return sch


def _encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(
        cfg, n_layers=cfg.encoder_layers, layer_pattern=("attn",),
        window_pattern=(0,), moe_experts=0, qkv_bias=False)


def model_schema(cfg: ModelConfig) -> PyTree:
    cfg.validate()
    period = cfg.pattern_period
    n_groups = cfg.n_layers // period
    cross = cfg.encoder_layers > 0
    sch: Dict[str, Any] = {
        "embed": layers.embed_schema(cfg),
        "final_norm": layers.rmsnorm_schema(cfg.d_model),
        "groups": {f"sub{j}": _sub_schema(cfg, j, n_groups, cross)
                   for j in range(period)},
    }
    if not cfg.tie_embeddings:
        sch["unembed"] = layers.unembed_schema(cfg)
    if cross:
        ecfg = _encoder_cfg(cfg)
        sch["encoder"] = {
            "groups": {"sub0": _sub_schema(ecfg, 0, ecfg.n_layers, False)},
            "final_norm": layers.rmsnorm_schema(cfg.d_model),
        }
    return sch


# ------------------------------------------------------------------- cache --
def cache_schema(cfg: ModelConfig, batch: int, max_seq: int) -> PyTree:
    """Decode-state tree as ParamSpecs, per sub-layer stacked over the
    n_groups: (B, S_max, Hkv*Dh) K and V planes for attention; the state
    ``h`` (float32) and the conv tail for mamba; ``c``, ``n``, ``m``, ``h``
    (float32) for the sLSTM; ``C``, ``n``, ``m`` (float32) for the mLSTM.
    All zeros, the sLSTM's stabilizer ``m`` included (the JAX package's
    cache; a cache-free sLSTM starts it at -1e30)."""
    period = cfg.pattern_period
    st = (cfg.n_layers // period,)
    d, hkv, dh = cfg.d_model, cfg.n_kv_heads, cfg.hd
    di = cfg.mamba_expand * d
    h_heads = cfg.n_heads
    dhead = d // max(h_heads, 1)
    z = dict(init="zeros", dtype=torch.float32)
    out = {}
    for j in range(period):
        kind = cfg.layer_pattern[j]
        if kind == "attn":
            shape = st + (batch, max_seq, hkv * dh)
            axes = ("stack", "batch", "kv_seq", "kv_flat")
            out[f"sub{j}"] = {"k": ParamSpec(shape, axes, init="zeros"),
                              "v": ParamSpec(shape, axes, init="zeros")}
        elif kind == "mamba":
            out[f"sub{j}"] = {
                "h": ParamSpec(st + (batch, di, cfg.mamba_d_state),
                               ("stack", "batch", "mamba_inner", None), **z),
                "conv": ParamSpec(st + (batch, cfg.mamba_d_conv - 1, di),
                                  ("stack", "batch", None, "mamba_inner"),
                                  init="zeros"),
            }
        elif kind == "slstm":
            axes = ("stack", "batch", "embed")
            out[f"sub{j}"] = {name: ParamSpec(st + (batch, d), axes, **z)
                              for name in ("c", "n", "m", "h")}
        elif kind == "mlstm":
            out[f"sub{j}"] = {
                "C": ParamSpec(st + (batch, h_heads, dhead, dhead),
                               ("stack", "batch", "heads", None, None), **z),
                "n": ParamSpec(st + (batch, h_heads, dhead),
                               ("stack", "batch", "heads", None), **z),
                "m": ParamSpec(st + (batch, 1), ("stack", "batch", None), **z),
            }
    return out


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device) -> PyTree:
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device),
                    cache_schema(cfg, batch, max_seq))


# ----------------------------------------------------------------- forward --
def _apply_sub(p, cfg: ModelConfig, j: int, x, positions, cache, cache_index,
               encoder_out, placement, use_flash: bool, collect_moe: bool):
    """One sub-layer; returns (x, the expert loads or None). A recurrent
    sub-layer with a cache writes its new state into the cache in place."""
    kind = cfg.layer_pattern[j]
    h = layers.rmsnorm(p["norm"], x, cfg.norm_eps)
    if kind == "attn":
        out, _ = attn_mod.attn(
            p["attn"], cfg, h, positions, window=cfg.layer_window(j),
            causal=True, cache=cache, cache_index=cache_index,
            use_flash=use_flash)
    else:
        if kind == "mamba":
            out, state = mamba_mod.mamba(p["mamba"], cfg, h, state=cache)
        elif kind == "slstm":
            out, state = xlstm_mod.slstm(p["cell"], cfg, h, state=cache)
        else:
            out, state = xlstm_mod.mlstm(p["cell"], cfg, h, state=cache)
        if cache is not None:
            for name, value in state.items():
                cache[name].copy_(value)
    x = x + out
    if "cross" in p and encoder_out is not None:
        h = layers.rmsnorm(p["cross_norm"], x, cfg.norm_eps)
        out, _ = attn_mod.attn(p["cross"], cfg, h, positions, causal=False,
                               kv_source=encoder_out, use_rope=False)
        x = x + out
    moe_load = None
    if "mlp" in p:
        h = layers.rmsnorm(p["mlp_norm"], x, cfg.norm_eps)
        x = x + layers.mlp(p["mlp"], h)
    elif "moe" in p:
        h = layers.rmsnorm(p["mlp_norm"], x, cfg.norm_eps)
        if collect_moe:
            out, stats = moe_mod.moe(p["moe"], cfg, h, placement=placement,
                                     return_stats=True)
            moe_load = stats["expert_load"]
        else:
            out = moe_mod.moe(p["moe"], cfg, h, placement=placement)
        x = x + out
    return x, moe_load


#: the remat policy: keep the outputs of the 2-D products and of the
#: router's top-k, recompute the rest
_SAVE_MATMULS = functools.partial(
    create_selective_checkpoint_contexts,
    [torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
     torch.ops.aten.topk.default])


def _apply_group(gp, cfg: ModelConfig, x, positions, gcache, cache_index,
                 encoder_out, gplace, use_flash: bool, collect_moe: bool):
    """One superblock (the JAX package's scan body); returns (x, the stacked
    expert loads of its MoE sub-layers or None)."""
    loads = []
    for j in range(cfg.pattern_period):
        sub_cache = gcache[f"sub{j}"] if gcache is not None else None
        place = gplace[j] if gplace is not None else None
        x, load = _apply_sub(gp[f"sub{j}"], cfg, j, x, positions, sub_cache,
                             cache_index, encoder_out, place, use_flash,
                             collect_moe)
        if load is not None:
            loads.append(load)
    return x, (torch.stack(loads) if loads else None)


def decoder_apply(params, cfg: ModelConfig, x, positions,
                  cache: Optional[PyTree] = None, cache_index: int = 0,
                  encoder_out: Optional[torch.Tensor] = None,
                  placements: Optional[torch.Tensor] = None,
                  use_flash: bool = False, remat: bool = True,
                  collect_moe: bool = False):
    """x: (B, T, D) -> (x, cache), or (x, cache, loads) with
    ``collect_moe``. The cache, when given, is updated in place and
    returned; without one the second value is None. ``encoder_out``
    (B, S, D) feeds the cross-attention sub-layers of an encoder-decoder.

    Each leaf of ``params["groups"]`` is a stacked (n_groups, ...) tensor
    or a sequence of its n_groups slices (the train step's autograd
    leaves).

    placements: (n_layers, E) physical slot of each logical expert, per
    layer (None = the identity). ``loads`` stacks each MoE sub-layer's
    ``expert_load`` (by physical slot) as (n_groups, MoE sub-layers per
    superblock, E), as the JAX package's scan does; None without MoE.

    ``remat`` checkpoints each superblock (see the module docstring) when
    there is no cache and autograd is recording; otherwise it changes
    nothing."""
    period = cfg.pattern_period
    n_groups = cfg.n_layers // period
    if placements is not None:
        placements = placements.reshape(n_groups, period, -1)
    groups = tree_map(lambda a: a.unbind(0) if torch.is_tensor(a) else a,
                      params["groups"])
    remat = remat and cache is None and torch.is_grad_enabled()
    group_loads = []
    for g in range(n_groups):
        gp = tree_map(lambda a: a[g], groups)
        gcache = (tree_map(lambda a: a[g], cache) if cache is not None
                  else None)
        gplace = placements[g] if placements is not None else None
        args = (gp, cfg, x, positions, gcache, cache_index, encoder_out,
                gplace, use_flash, collect_moe)
        if remat:
            x, loads = checkpoint(_apply_group, *args, use_reentrant=False,
                                  context_fn=_SAVE_MATMULS)
        else:
            x, loads = _apply_group(*args)
        if loads is not None:
            group_loads.append(loads)
    if collect_moe:
        return x, cache, (torch.stack(group_loads) if group_loads else None)
    return x, cache


def encode(params, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """The whisper-style encoder over stub frame embeddings (B, F, D):
    sinusoidal frame positions, then ``cfg.encoder_layers`` non-causal
    plain attention layers (no RoPE, never the flash kernel) with dense
    MLPs, then a final norm."""
    ecfg = _encoder_cfg(cfg)
    _, f, d = frames.shape
    pos = torch.arange(f, device=frames.device)
    half = d // 2
    freqs = 10_000.0 ** (-torch.arange(half, dtype=torch.float32,
                                       device=frames.device) / half)
    angles = pos[:, None] * freqs
    x = frames + torch.cat([torch.sin(angles), torch.cos(angles)],
                           dim=-1).to(frames.dtype)[None]
    groups = tree_map(lambda a: a.unbind(0) if torch.is_tensor(a) else a,
                      params["encoder"]["groups"]["sub0"])
    for g in range(ecfg.n_layers):
        gp = tree_map(lambda a: a[g], groups)
        h = layers.rmsnorm(gp["norm"], x, cfg.norm_eps)
        out, _ = attn_mod.attn(gp["attn"], ecfg, h, pos, causal=False,
                               use_rope=False, use_flash=False)
        x = x + out
        h = layers.rmsnorm(gp["mlp_norm"], x, cfg.norm_eps)
        x = x + layers.mlp(gp["mlp"], h)
    return layers.rmsnorm(params["encoder"]["final_norm"], x, cfg.norm_eps)


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            cache: Optional[PyTree] = None, cache_index: int = 0,
            placements: Optional[torch.Tensor] = None,
            use_flash: bool = False, remat: bool = True,
            collect_moe: bool = False):
    """batch: {"tokens": (B, T)} and, by front end, {"frames"} (audio,
    encoded here), {"encoder_out"} (audio, encoded once by the caller for
    the decode steps) or {"pixel_embeds"} (B, P, D) (a vision prefix,
    prepended). Returns (hidden (B, T [+ P], D), cache), or (hidden, cache,
    loads) with ``collect_moe`` (see :func:`decoder_apply` for
    ``placements``, ``remat`` and ``loads``)."""
    tokens = batch["tokens"]
    x = layers.embed(params["embed"], tokens).to(torch.bfloat16)
    encoder_out = batch.get("encoder_out")
    if (encoder_out is None and cfg.frontend == "audio_stub"
            and "frames" in batch):
        encoder_out = encode(params, cfg, batch["frames"])
    elif cfg.frontend == "vision_stub" and "pixel_embeds" in batch:
        x = torch.cat([batch["pixel_embeds"].to(x.dtype), x], dim=1)
    t = x.shape[1]
    positions = cache_index + torch.arange(t, device=x.device)
    x, new_cache, *loads = decoder_apply(
        params, cfg, x, positions, cache=cache, cache_index=cache_index,
        encoder_out=encoder_out, placements=placements, use_flash=use_flash,
        remat=remat, collect_moe=collect_moe)
    x = layers.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return (x, new_cache, *loads)


def logits_from_hidden(params, cfg: ModelConfig, hidden: torch.Tensor
                       ) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = layers.dot(hidden, params["embed"]["tokens"].T)
    else:
        logits = layers.unembed(params["unembed"], hidden)
    # mask vocab padding
    if cfg.vocab_padded != cfg.vocab:
        mask = torch.zeros(cfg.vocab_padded, dtype=logits.dtype,
                           device=logits.device)
        mask[cfg.vocab:] = -1e30
        logits = logits + mask
    return logits


def _chunk_loss(params, cfg: ModelConfig, hidden: torch.Tensor,
                labels: torch.Tensor):
    """One sequence chunk's summed cross-entropy and its count of labels
    (``labels < 0`` are masked out), over float32 logits."""
    logits = logits_from_hidden(params, cfg, hidden).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.clamp(min=0).long()[..., None])[..., 0]
    valid = (labels >= 0).to(torch.float32)
    return torch.sum((logz - gold) * valid), torch.sum(valid)


def lm_loss(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            placements: Optional[torch.Tensor] = None,
            use_flash: bool = False, remat: bool = True,
            loss_chunks: int = 8, collect_moe: bool = False):
    """Next-token cross-entropy of ``batch`` ({"tokens", "labels"}, each
    (B, T), and a front end's inputs as :func:`forward` takes them), the
    mean over the labels that are not negative; with ``collect_moe`` also
    the expert loads (see :func:`decoder_apply`). A vision prefix is
    dropped before the loss (loss on text only).

    The logits are made per sequence chunk: ``loss_chunks`` chunks, or the
    largest count below it that divides T (the JAX package's rule), each
    under ``torch.utils.checkpoint`` while autograd records, so one chunk's
    float32 (B, T/chunks, V) logits exist at a time, in the backward pass
    too (the JAX package's ``lax.map``)."""
    hidden, _, *loads = forward(params, cfg, batch, placements=placements,
                                use_flash=use_flash, remat=remat,
                                collect_moe=collect_moe)
    labels = batch["labels"]
    if cfg.frontend == "vision_stub" and "pixel_embeds" in batch:
        hidden = hidden[:, batch["pixel_embeds"].shape[1]:]
    t = hidden.shape[1]
    chunks = min(loss_chunks, t)
    while t % chunks:
        chunks -= 1
    size = t // chunks
    sums, counts = [], []
    for c in range(chunks):
        args = (params, cfg, hidden[:, c * size:(c + 1) * size],
                labels[:, c * size:(c + 1) * size])
        if torch.is_grad_enabled():
            s, n = checkpoint(_chunk_loss, *args, use_reentrant=False)
        else:
            s, n = _chunk_loss(*args)
        sums.append(s)
        counts.append(n)
    loss = torch.sum(torch.stack(sums)) / torch.clamp(
        torch.sum(torch.stack(counts)), min=1.0)
    return (loss, loads[0]) if collect_moe else loss
