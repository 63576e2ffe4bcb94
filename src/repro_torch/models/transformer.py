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

On a mesh (ROADMAP A7b; the JAX package's GSPMD partitioner under
``sharding.ctx.use_mesh``) the parameters are DTensors laid out by
``sharding.rules.param_shardings`` (TP on "model", FSDP on "data"), and so
are the batch, the hidden state (pinned ("dp", None, None) by
``ctx.constrain`` at the JAX package's call sites) and the cache. Each
layer below has one body, for plain tensors and DTensors alike: it is one
local call (:class:`~repro_torch.sharding.local.Local`, the identity on
plain tensors), its norm and its mixer running on each rank's shard, with
these layouts:

* **attention**: the query heads split over "model" where they divide it
  (tensor parallelism: ``wq``'s columns, ``wo``'s rows; the output is a
  partial sum, all-reduced into the residual), the KV heads too where they
  also divide; otherwise the KV heads are replicated and each rank picks
  its query heads' KV heads (``attend(kv_heads=...)``), and where the query
  heads do not divide, the layer runs replicated. The parameter layout
  splits a flat "q_heads"/"kv_flat" dim wherever its size divides, which
  may cut a head in two (qwen2's 7 heads of 8 on 2 ranks), so each weight
  is redistributed to the head-aligned layout first. The flash kernel, a
  ctypes launch on ``data_ptr()`` that cannot take a DTensor, runs per rank
  on the local heads and batch shard, as the plain version does on the
  CPU. A KV cache stays in its layout where that is the local one (heads
  over "model", batch over "dp"): the step writes the local shard in
  place. Otherwise (KV heads replicated, or the batch too small to split
  and the cache split on its sequence) it is gathered and written back.
* **dense MLP**: the hidden columns split over "model" where they divide.
* **mamba, sLSTM, mLSTM**: their scans and time loops have no sharding
  strategy, so each runs replicated on "model" with its weights and state
  gathered, on the rank's batch shard.
* **MoE**: :func:`~repro_torch.models.moe.moe` (routing replicated, or
  per data shard in dispatch groups with ``REPRO_PERF_MOE_GROUPED``;
  experts over "model").
* **embedding and logits**: the table is gathered for the lookup
  (``F.embedding`` takes no vocabulary-split table); the logits split the
  vocabulary over "model" ("dp", None, "tp"), and the loss gathers each
  chunk's vocabulary for its ``logsumexp``.

The ``REPRO_PERF_*`` flags read here (:mod:`repro_torch.flags`):

* ``DECODE_WS``: at decode (a cache, T = 1) on a mesh whose "data" axis
  splits the layer's weights, :func:`_apply_sub` pins the activation's
  embed dim to "sp" ("data") for the layer and back to "dp" after it, as
  the JAX package does. The attention, dense MLP and MoE bodies then keep
  every weight in its FSDP layout (``sharding.local.stationary``): the
  norm's variance comes from the activation gathered over "data", each
  product that contracts the embed dim sums this rank's rows' partial
  products over "data" (an activation-sized all-reduce), and the output
  projections compute this rank's slice of the embed dim. The attention
  itself runs on the cache's batch shard. The recurrent layers keep their
  replicated layout (their weights gathered), and the embedding and the
  logits are outside the pinned span, as in the JAX package.
* ``ATTN_SHARD``: the ("dp", "tp") pins on q, k and v. The layer body
  already lays them out so (whole heads over "model" where they divide,
  the batch over the data axes where it divides, never the head dim), so
  the pin moves nothing; :func:`_attn_shard_pin` checks that it holds.
* ``BF16_LOSS``: :func:`logits_from_hidden` casts the logits to bfloat16
  before the vocabulary-padding mask (the loss's ``logsumexp`` stays in
  float32).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from .. import flags
from ..sharding import ctx as shard_ctx
from ..sharding.local import (DATA_AXIS, Local, axis_size, axis_sum,
                              batch_split, data_chunk, embed_sharded,
                              fsdp_split, is_dtensor, layout_batch, mesh_of,
                              model_size, replicated, residual, stationary,
                              wait_local)
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
def _norm(scale, x, eps: float):
    """RMSNorm on each rank's shard, the scale gathered."""
    loc = Local.of(x)
    return loc.out(layers.rmsnorm({"scale": loc.param(scale)}, loc.act(x),
                                  eps))


def _operand(h, w):
    """``h`` cast as :func:`~repro_torch.models.layers.dot` casts it for a
    product with ``w``, in a replicated call. A tensor-parallel call's
    gradient for its input is a partial sum per rank; cast there, each
    partial would be rounded to bfloat16 on its own. Cast here, the
    partial sums are all-reduced in the product's dtype first (the
    backward of :meth:`Local.out`), and the cast rounds their sum, as the
    unsharded layer's cast does."""
    dt = torch.promote_types(h.dtype, w.dtype)
    if h.dtype == dt:
        return h
    loc = Local.of(h)
    return loc.out(loc.act(h).to(dt))


def _attention(p, scale, cfg: ModelConfig, x, positions, eps: float, *,
               window: int = 0, causal: bool = True, cache=None,
               cache_index: int = 0, kv_source=None, use_rope: bool = True,
               use_flash: bool = False):
    """The norm (replicated on "model") and the attention of one
    sub-layer; returns its output for the residual. ``cache`` ({"k",
    "v"}) is updated in place."""
    if _ws(x):
        return _attention_ws(p, scale, cfg, x, positions, eps,
                             window=window, causal=causal, cache=cache,
                             cache_index=cache_index, kv_source=kv_source,
                             use_rope=use_rope)
    q_split, kv_split, lcfg = _heads(cfg, model_size(mesh_of(x)))
    loc = Local.of(x, tp=q_split)
    qd, kvd = (1 if q_split else None), (1 if kv_split else None)
    lp = {"wq": loc.param(p["wq"], qd), "wk": loc.param(p["wk"], kvd),
          "wv": loc.param(p["wv"], kvd),
          "wo": loc.param(p["wo"], 0 if q_split else None)}
    if "bq" in p:
        lp["bq"] = loc.param(p["bq"], 0 if q_split else None)
        lp["bk"] = loc.param(p["bk"], 0 if kv_split else None)
        lp["bv"] = loc.param(p["bv"], 0 if kv_split else None)
    h = _norm(scale, x, eps)
    src = h if kv_source is None else kv_source
    # each projection casts its own operand, in the order ``attn`` does:
    # autograd sums their rounded gradients
    q, k, v = (layers.dot(loc.act(_operand(a, p[w])), lp[w]) for a, w in
               ((h, "wq"), (src, "wk"), (src, "wv")))
    return loc.out(_attend_local(
        attn_mod.attend, loc, lp, cfg, lcfg, q, k, v, positions, cache,
        window=window, causal=causal, cache_index=cache_index,
        cross=kv_source is not None, use_rope=use_rope, use_flash=use_flash,
        pin=_attn_shard_pin(loc, q_split, kv_split)))


def _heads(cfg: ModelConfig, m: int):
    """The attention's heads on a "model" axis of ``m`` ranks: whether the
    query heads split there, whether the KV heads do too, and the config
    of one rank's heads."""
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    q_split = m > 1 and hq % m == 0
    kv_split = q_split and hkv % m == 0
    lcfg = cfg if not q_split else dataclasses.replace(
        cfg, n_heads=hq // m, n_kv_heads=hkv // m if kv_split else hkv,
        head_dim=cfg.hd)
    return q_split, kv_split, lcfg


def _attend_local(fn, loc: Local, lp, cfg: ModelConfig, lcfg: ModelConfig,
                  q, k, v, positions, cache, **kw):
    """``fn`` (``attention.attend`` or ``attend_heads``) on the call's
    local heads and batch shard: a rank that holds some query heads and
    all the KV heads picks its query heads' KV heads, and the cache's
    local shard takes the step's K/V in place (written back where it is
    gathered)."""
    q_split = lcfg.n_heads != cfg.n_heads
    kv_split = lcfg.n_kv_heads != cfg.n_kv_heads
    kv_heads = None
    if q_split and not kv_split:
        first = loc.model_rank * lcfg.n_heads
        kv_heads = torch.arange(first, first + lcfg.n_heads, device=q.device
                                ) // (cfg.n_heads // cfg.n_kv_heads)
    lcache, writes = None, []
    if cache is not None:
        lcache = {}
        for name in ("k", "v"):
            lcache[name], write = loc.state(cache[name],
                                            2 if kv_split else None)
            writes.append(write)
    out, _ = fn(lp, lcfg, q, k, v, positions, cache=lcache,
                kv_heads=kv_heads, **kw)
    for write in writes:
        write()
    return out


def _attn_shard_pin(loc: Local, q_split: bool, kv_split: bool):
    """``REPRO_PERF_ATTN_SHARD``'s ("dp", "tp", None, None) pins on the
    local (B, H, S, Dh) q, k and v of a call on a mesh (None without the
    flag or the mesh). The call already holds them so: the batch over the
    data axes where it divides (the activation's own pin), and whole heads
    over "model" exactly where the pin resolves "tp" to it (the query heads
    where they divide the axis; the KV heads where they divide it too,
    which their count's dividing the query heads' makes the same test). So
    the pin checks the layout and moves nothing."""
    if loc.mesh is None or not flags.enabled("ATTN_SHARD"):
        return None
    from torch.distributed.tensor import Replicate

    from .schema import placements_for
    mesh = loc.mesh
    sizes = [int(mesh.size(i)) for i in range(mesh.ndim)]

    def pin(qt, kt, vt):
        b = qt.shape[0] * math.prod(n for n, s in zip(sizes, loc.split) if s)
        for t, heads_split in ((qt, q_split), (kt, kv_split),
                               (vt, kv_split)):
            h = t.shape[1] * (model_size(mesh) if heads_split else 1)
            want = placements_for(shard_ctx.resolve_spec(
                mesh, (b, h) + tuple(t.shape[2:]), ("dp", "tp", None, None)),
                mesh)
            have = loc._placements(0, 1 if heads_split else None, False,
                                   Replicate())
            if any(n > 1 and a != w for n, a, w in zip(sizes, have, want)):
                raise RuntimeError(
                    f"REPRO_PERF_ATTN_SHARD: the layer holds {have}, the "
                    f"pin asks for {want}")
        return qt, kt, vt
    return pin


# ------------------------------------------------ weight-stationary decode --
def _ws(x) -> bool:
    """Whether ``x`` is in the decode-ws layout (``REPRO_PERF_DECODE_WS``):
    a DTensor whose embed (last) dim is split over a "data" axis of size
    > 1."""
    if not is_dtensor(x) or axis_size(x.device_mesh, DATA_AXIS) < 2:
        return False
    pl = x.placements[tuple(x.device_mesh.mesh_dim_names).index(DATA_AXIS)]
    return getattr(pl, "dim", None) == x.dim() - 1


def _ws_norm(scale, x, eps: float) -> torch.Tensor:
    """RMSNorm of the decode-ws ``x``: the variance over the activation
    gathered on "data", times this rank's slice of the scale (kept split
    there); the local (B, T, D / data) slice of the normed activation,
    element for element ``layers.rmsnorm``'s."""
    mesh = x.device_mesh
    h = replicated(x).to_local().to(torch.float32)
    var = torch.mean(h * h, dim=-1, keepdim=True)
    return (data_chunk(h, mesh) * torch.rsqrt(var + eps)
            * stationary(scale)).to(x.dtype)


def _ws_in(hs: torch.Tensor, w, model_dim: Optional[int] = None
           ) -> torch.Tensor:
    """``h @ w`` from this rank's embed slice ``hs`` of ``h`` and its rows
    of ``w`` (the embed dim, split over "data"): the partial products
    summed over "data"; the columns split on "model" along ``model_dim``
    of ``w``."""
    return axis_sum(layers.dot(hs, stationary(w, model_dim)), w.device_mesh)


def _ws_out(a: torch.Tensor, w, model_dim: Optional[int] = None
            ) -> torch.Tensor:
    """This rank's embed slice of ``a @ w``, ``w``'s columns (the embed
    dim) split over "data"; a partial sum over "model" where ``w``'s rows
    split there (``model_dim`` 0)."""
    return layers.dot(a, stationary(w, model_dim))


def _rows(t: torch.Tensor, loc: Local, gather: bool) -> torch.Tensor:
    """The local ``t``'s batch rows cut to ``loc``'s batch shard (``gather``
    False: a local slice of all the rows), or gathered whole from it (an
    activation all-gather over the data axes the batch splits on)."""
    if not any(loc.split):
        return t
    from torch.distributed.tensor import Replicate, Shard
    rows = [Shard(0) if s else Replicate() for s in loc.split]
    whole = [Replicate()] * len(loc.split)
    src, dst = (rows, whole) if gather else (whole, rows)
    return wait_local(loc.wrap(t, src).redistribute(loc.mesh, dst))


def _attention_ws(p, scale, cfg: ModelConfig, x, positions, eps: float, *,
                  window: int, causal: bool, cache, cache_index: int,
                  kv_source, use_rope: bool):
    """:func:`_attention` in the decode-ws layout (see the module
    docstring): q, k and v from the stationary weights, the attention on
    the cache's batch shard (all rows without a cache), and this rank's
    embed slice of the output projection."""
    mesh = x.device_mesh
    q_split, kv_split, lcfg = _heads(cfg, model_size(mesh))
    qd, kvd = (1 if q_split else None), (1 if kv_split else None)
    hs = _ws_norm(scale, x, eps)
    srcs = hs if kv_source is None else data_chunk(
        replicated(kv_source).to_local(), mesh)
    q = _ws_in(hs, p["wq"], qd)
    k, v = _ws_in(srcs, p["wk"], kvd), _ws_in(srcs, p["wv"], kvd)
    lp = {}
    for name, split in (("bq", q_split), ("bk", kv_split), ("bv", kv_split)):
        if name in p:
            lp[name] = stationary(p[name], 0 if split else None)
    split = (batch_split(cache["k"]) if cache is not None
             else (False,) * mesh.ndim)
    lb = Local(mesh, split, tp=q_split)
    q, k, v = (_rows(a, lb, gather=False) for a in (q, k, v))
    heads = _attend_local(
        attn_mod.attend_heads, lb, lp, cfg, lcfg, q, k, v, positions, cache,
        window=window, causal=causal, cache_index=cache_index,
        cross=kv_source is not None, use_rope=use_rope)
    heads = _rows(heads, lb, gather=True)
    out = _ws_out(heads, p["wo"], 0 if q_split else None)
    return embed_sharded(out, mesh, partial_model=q_split)


def _mlp(p, scale, cfg: ModelConfig, x, eps: float):
    """The norm and the gated MLP (``layers.mlp``'s SwiGLU) of one
    sub-layer, its hidden columns split over "model" where they divide."""
    m = model_size(mesh_of(x))
    split = m > 1 and cfg.d_ff % m == 0
    cols = 1 if split else None
    if _ws(x):
        hs = _ws_norm(scale, x, eps)
        gate = F.silu(_ws_in(hs, p["w_gate"], cols))
        up = _ws_in(hs, p["w_up"], cols)
        return embed_sharded(_ws_out(gate * up, p["w_down"],
                                     0 if split else None),
                             x.device_mesh, partial_model=split)
    loc = Local.of(x, tp=split)
    lp = {"w_gate": loc.param(p["w_gate"], cols),
          "w_up": loc.param(p["w_up"], cols),
          "w_down": loc.param(p["w_down"], 0 if split else None)}
    h = _norm(scale, x, eps)
    gate = F.silu(layers.dot(loc.act(_operand(h, p["w_gate"])),
                             lp["w_gate"]))
    up = layers.dot(loc.act(_operand(h, p["w_up"])), lp["w_up"])
    return loc.out(layers.dot(gate * up, lp["w_down"]))


_RECURRENT = {"mamba": mamba_mod.mamba, "slstm": xlstm_mod.slstm,
              "mlstm": xlstm_mod.mlstm}


def _recurrent(kind: str, p, scale, cfg: ModelConfig, x, eps: float,
               cache=None):
    """The norm and a mamba / sLSTM / mLSTM layer, replicated on "model" on
    the rank's batch shard; ``cache`` takes the new state in place."""
    loc = Local.of(x)
    lp = {name: loc.param(w) for name, w in p.items()}
    h = layers.rmsnorm({"scale": loc.param(scale)}, loc.act(x), eps)
    state, writes = None, []
    if cache is not None:
        state = {}
        for name, c in cache.items():
            state[name], write = loc.state(c)
            writes.append(write)
    out, new = _RECURRENT[kind](lp, cfg, h, state=state)
    if cache is not None:
        for name, value in new.items():
            state[name].copy_(value)
        for write in writes:
            write()
    return loc.out(out)


def _apply_sub(p, cfg: ModelConfig, j: int, x, positions, cache, cache_index,
               encoder_out, placement, use_flash: bool, collect_moe: bool):
    """One sub-layer; returns (x, the expert loads or None). A recurrent
    sub-layer with a cache writes its new state into the cache in place."""
    kind = cfg.layer_pattern[j]
    eps = cfg.norm_eps
    # weight-stationary decode (REPRO_PERF_DECODE_WS, the module docstring):
    # where "data" splits the layer's weights, the embed dim goes to "sp"
    decode_ws = (flags.enabled("DECODE_WS") and cache is not None
                 and x.shape[1] == 1 and fsdp_split(p["norm"]["scale"]))
    if decode_ws:
        x = shard_ctx.constrain(x, None, None, "sp")
    if kind == "attn":
        out = _attention(p["attn"], p["norm"]["scale"], cfg, x, positions,
                         eps, window=cfg.layer_window(j), cache=cache,
                         cache_index=cache_index, use_flash=use_flash)
    else:
        key = "mamba" if kind == "mamba" else "cell"
        out = _recurrent(kind, p[key], p["norm"]["scale"], cfg, x, eps,
                         cache=cache)
    x = residual(x, out)
    if "cross" in p and encoder_out is not None:
        out = _attention(p["cross"], p["cross_norm"]["scale"], cfg, x,
                         positions, eps, causal=False, kv_source=encoder_out,
                         use_rope=False)
        x = residual(x, out)
    moe_load = None
    if "mlp" in p:
        x = residual(x, _mlp(p["mlp"], p["mlp_norm"]["scale"], cfg, x, eps))
    elif "moe" in p:
        if _ws(x):
            out = moe_mod.moe_stationary(
                p["moe"], cfg, _ws_norm(p["mlp_norm"]["scale"], x, eps),
                x.device_mesh, placement=placement, return_stats=collect_moe)
        else:
            out = moe_mod.moe(p["moe"], cfg,
                              _norm(p["mlp_norm"]["scale"], x, eps),
                              placement=placement, return_stats=collect_moe)
        if collect_moe:
            out, stats = out
            moe_load = stats["expert_load"]
        if _ws(x):
            out = embed_sharded(out, x.device_mesh)
        x = residual(x, out)
    if decode_ws:
        x = shard_ctx.constrain(x, "dp", None, None)
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
    loc = Local.of(frames)
    f = loc.act(frames)
    _, t, d = f.shape
    pos = torch.arange(t, device=f.device)
    half = d // 2
    freqs = 10_000.0 ** (-torch.arange(half, dtype=torch.float32,
                                       device=f.device) / half)
    angles = pos[:, None] * freqs
    x = loc.out(f + torch.cat([torch.sin(angles), torch.cos(angles)],
                              dim=-1).to(f.dtype)[None])
    eps = cfg.norm_eps
    groups = tree_map(lambda a: a.unbind(0) if torch.is_tensor(a) else a,
                      params["encoder"]["groups"]["sub0"])
    for g in range(ecfg.n_layers):
        gp = tree_map(lambda a: a[g], groups)
        x = residual(x, _attention(gp["attn"], gp["norm"]["scale"], ecfg, x,
                                   pos, eps, causal=False, use_rope=False))
        x = residual(x, _mlp(gp["mlp"], gp["mlp_norm"]["scale"], ecfg, x,
                             eps))
    return _norm(params["encoder"]["final_norm"]["scale"], x, eps)


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
    ``placements``, ``remat`` and ``loads``).

    With DTensor parameters (see the module docstring) the hidden state
    and the cache are DTensors too, and a plain batch tensor is laid out
    by the batch spec on the parameters' mesh."""
    batch = layout_batch(batch, mesh_of(params["embed"]["tokens"]))
    tokens = batch["tokens"]
    # the table gathered for the lookup, on each rank's batch shard
    loc = Local.of(tokens)
    x = loc.out(layers.embed({"tokens": loc.param(params["embed"]["tokens"])},
                             loc.act(tokens)).to(torch.bfloat16))
    x = shard_ctx.constrain(x, "dp", None, None)
    encoder_out = batch.get("encoder_out")
    if (encoder_out is None and cfg.frontend == "audio_stub"
            and "frames" in batch):
        encoder_out = encode(params, cfg, batch["frames"])
    elif cfg.frontend == "vision_stub" and "pixel_embeds" in batch:
        loc = Local.of(x)
        x = loc.out(torch.cat([loc.act(batch["pixel_embeds"]).to(x.dtype),
                               loc.act(x)], dim=1))
    t = x.shape[1]
    positions = cache_index + torch.arange(t, device=x.device)
    x, new_cache, *loads = decoder_apply(
        params, cfg, x, positions, cache=cache, cache_index=cache_index,
        encoder_out=encoder_out, placements=placements, use_flash=use_flash,
        remat=remat, collect_moe=collect_moe)
    x = _norm(params["final_norm"]["scale"], x, cfg.norm_eps)
    return (x, new_cache, *loads)


def logits_from_hidden(params, cfg: ModelConfig, hidden: torch.Tensor
                       ) -> torch.Tensor:
    """(B, T, V) logits, the vocabulary padding masked; on a mesh the
    vocabulary split over "model" where it divides, the padding masked on
    each rank's columns."""
    m = model_size(mesh_of(hidden))
    split = m > 1 and cfg.vocab_padded % m == 0
    loc = Local.of(hidden, tp=split)
    h = loc.act(hidden)
    if cfg.tie_embeddings:
        w = loc.param(params["embed"]["tokens"], 0 if split else None)
        logits = layers.dot(h, w.T)
    else:
        logits = layers.unembed({"w": loc.param(params["unembed"]["w"],
                                                1 if split else None)}, h)
    if flags.enabled("BF16_LOSS"):
        # the (B, T, V) logits stay bfloat16 until the loss's float32
        # logsumexp (the JAX package's flag)
        logits = logits.to(torch.bfloat16)
    # mask vocab padding
    if cfg.vocab_padded != cfg.vocab:
        mask = torch.zeros(cfg.vocab_padded, dtype=logits.dtype,
                           device=logits.device)
        mask[cfg.vocab:] = -1e30
        if split:
            cols = logits.shape[-1]
            mask = mask[loc.model_rank * cols:(loc.model_rank + 1) * cols]
        logits = logits + mask
    return loc.out(logits, model_dim=2 if split else None)


def _chunk_loss(params, cfg: ModelConfig, hidden: torch.Tensor,
                labels: torch.Tensor):
    """One sequence chunk's summed cross-entropy and its count of labels
    (``labels < 0`` are masked out), over float32 logits. On a mesh the
    logits are pinned ("dp", None, "tp"), and the vocabulary is gathered
    for the ``logsumexp`` (which has no vocabulary-split strategy) on each
    rank's batch shard; both sums come back as plain 0-d tensors, the same
    on every rank."""
    hidden = shard_ctx.constrain(hidden, "dp", None, None)
    logits = shard_ctx.constrain(
        logits_from_hidden(params, cfg, hidden).to(torch.float32),
        "dp", None, "tp")
    loc = Local.of(logits)
    logits, labels = loc.act(logits), loc.act(labels)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.clamp(min=0).long()[..., None])[..., 0]
    valid = (labels >= 0).to(torch.float32)
    return (loc.total(torch.sum((logz - gold) * valid)),
            loc.total(torch.sum(valid)))


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
    labels = layout_batch({"labels": batch["labels"]},
                          mesh_of(hidden))["labels"]
    if cfg.frontend == "vision_stub" and "pixel_embeds" in batch:
        hidden = hidden[:, batch["pixel_embeds"].shape[1]:]
    hidden = shard_ctx.constrain(hidden, "dp", None, None)
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
