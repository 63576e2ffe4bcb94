"""Decoder-only LM assembler — the JAX package's ``models/transformer.py``
for the layer kinds the port has: attention followed by a dense SwiGLU MLP
or an MoE MLP (``models/moe.py``, with SkewShield expert placements).

Layers are grouped into *superblocks* of ``cfg.layer_pattern`` length with
stacked parameters (leading ``n_groups`` dim), as in the JAX package, so a
parameter tree converts one-to-one; the JAX package's ``lax.scan`` over the
groups is a Python loop here, over ``unbind`` views of the stacked leaves
(so autograd hands each stacked leaf one gradient, the stack of its
groups'). The same forward serves training and a cache-free step
(cache=None), prefill (cache + index 0, T = prompt) and decode (cache +
index t, T = 1).

Training: :func:`lm_loss` is the next-token cross-entropy with the logits
made one sequence chunk at a time. ``remat`` recomputes each superblock in
the backward pass, keeping only the outputs of the plain 2-D products
(``aten.mm``/``aten.addmm``): the JAX package's ``jax.checkpoint`` with
``dots_with_no_batch_dims_saveable``, so the experts' batched products
(``bmm``) are recomputed, as there.

mamba, sLSTM and mLSTM layers, the whisper encoder and the vision prefix
raise ``NotImplementedError`` until their slices.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from . import attention as attn_mod
from . import layers
from . import moe as moe_mod
from .config import ModelConfig
from .schema import ParamSpec, tree_map

PyTree = Any


def _check_ported(cfg: ModelConfig) -> None:
    missing = sorted({k for k in cfg.layer_pattern if k != "attn"})
    if cfg.encoder_layers or cfg.frontend != "none":
        missing.append(f"frontend {cfg.frontend}")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (ROADMAP "
            "Queue A item 4)")


# ------------------------------------------------------------------ schema --
def _sub_schema(cfg: ModelConfig, j: int, n_groups: int):
    stack = (n_groups,)
    sch: Dict[str, Any] = {"norm": layers.rmsnorm_schema(cfg.d_model, stack),
                           "attn": attn_mod.attn_schema(cfg, stack)}
    if cfg.d_ff > 0:
        sch["mlp_norm"] = layers.rmsnorm_schema(cfg.d_model, stack)
        if cfg.layer_is_moe(j):
            sch["moe"] = moe_mod.moe_schema(cfg, stack)
        else:
            sch["mlp"] = layers.mlp_schema(cfg, stack)
    return sch


def model_schema(cfg: ModelConfig) -> PyTree:
    cfg.validate()
    _check_ported(cfg)
    period = cfg.pattern_period
    n_groups = cfg.n_layers // period
    sch: Dict[str, Any] = {
        "embed": layers.embed_schema(cfg),
        "final_norm": layers.rmsnorm_schema(cfg.d_model),
        "groups": {f"sub{j}": _sub_schema(cfg, j, n_groups)
                   for j in range(period)},
    }
    if not cfg.tie_embeddings:
        sch["unembed"] = layers.unembed_schema(cfg)
    return sch


# ------------------------------------------------------------------- cache --
def cache_schema(cfg: ModelConfig, batch: int, max_seq: int) -> PyTree:
    """Decode-state tree as ParamSpecs: per attention sub-layer, stacked
    (n_groups, B, S_max, Hkv*Dh) K and V planes."""
    _check_ported(cfg)
    n_groups = cfg.n_layers // cfg.pattern_period
    shape = (n_groups, batch, max_seq, cfg.n_kv_heads * cfg.hd)
    axes = ("stack", "batch", "kv_seq", "kv_flat")
    return {f"sub{j}": {"k": ParamSpec(shape, axes, init="zeros"),
                        "v": ParamSpec(shape, axes, init="zeros")}
            for j in range(cfg.pattern_period)}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device) -> PyTree:
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device),
                    cache_schema(cfg, batch, max_seq))


# ----------------------------------------------------------------- forward --
def _apply_sub(p, cfg: ModelConfig, j: int, x, positions, cache, cache_index,
               placement, use_flash: bool, collect_moe: bool):
    """One sub-layer; returns (x, the expert loads or None)."""
    h = layers.rmsnorm(p["norm"], x, cfg.norm_eps)
    out, _ = attn_mod.attn(
        p["attn"], cfg, h, positions, window=cfg.layer_window(j),
        causal=True, cache=cache, cache_index=cache_index,
        use_flash=use_flash)
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


#: the remat policy: keep the outputs of the 2-D products, recompute the rest
_SAVE_MATMULS = functools.partial(
    create_selective_checkpoint_contexts,
    [torch.ops.aten.mm.default, torch.ops.aten.addmm.default])


def _apply_group(gp, cfg: ModelConfig, x, positions, gcache, cache_index,
                 gplace, use_flash: bool, collect_moe: bool):
    """One superblock (the JAX package's scan body); returns (x, the stacked
    expert loads of its MoE sub-layers or None)."""
    loads = []
    for j in range(cfg.pattern_period):
        sub_cache = gcache[f"sub{j}"] if gcache is not None else None
        place = gplace[j] if gplace is not None else None
        x, load = _apply_sub(gp[f"sub{j}"], cfg, j, x, positions, sub_cache,
                             cache_index, place, use_flash, collect_moe)
        if load is not None:
            loads.append(load)
    return x, (torch.stack(loads) if loads else None)


def decoder_apply(params, cfg: ModelConfig, x, positions,
                  cache: Optional[PyTree] = None, cache_index: int = 0,
                  placements: Optional[torch.Tensor] = None,
                  use_flash: bool = False, remat: bool = True,
                  collect_moe: bool = False):
    """x: (B, T, D) -> (x, cache), or (x, cache, loads) with
    ``collect_moe``. The cache, when given, is updated in place and
    returned; without one the second value is None.

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
    _check_ported(cfg)
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
        args = (gp, cfg, x, positions, gcache, cache_index, gplace,
                use_flash, collect_moe)
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


def forward(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            cache: Optional[PyTree] = None, cache_index: int = 0,
            placements: Optional[torch.Tensor] = None,
            use_flash: bool = False, remat: bool = True,
            collect_moe: bool = False):
    """batch: {"tokens": (B, T)}. Returns (hidden (B, T, D), cache), or
    (hidden, cache, loads) with ``collect_moe`` (see :func:`decoder_apply`
    for ``placements``, ``remat`` and ``loads``)."""
    tokens = batch["tokens"]
    x = layers.embed(params["embed"], tokens).to(torch.bfloat16)
    t = x.shape[1]
    positions = cache_index + torch.arange(t, device=x.device)
    x, new_cache, *loads = decoder_apply(
        params, cfg, x, positions, cache=cache, cache_index=cache_index,
        placements=placements, use_flash=use_flash, remat=remat,
        collect_moe=collect_moe)
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
    (B, T)), the mean over the labels that are not negative; with
    ``collect_moe`` also the expert loads (see :func:`decoder_apply`).

    The logits are made per sequence chunk: ``loss_chunks`` chunks, or the
    largest count below it that divides T (the JAX package's rule), each
    under ``torch.utils.checkpoint`` while autograd records, so one chunk's
    float32 (B, T/chunks, V) logits exist at a time, in the backward pass
    too (the JAX package's ``lax.map``)."""
    hidden, _, *loads = forward(params, cfg, batch, placements=placements,
                                use_flash=use_flash, remat=remat,
                                collect_moe=collect_moe)
    labels = batch["labels"]
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
