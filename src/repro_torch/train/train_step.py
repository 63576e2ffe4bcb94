"""The train and serve steps — the JAX package's ``train/train_step.py``.

``make_train_step`` is microbatched gradient accumulation and an AdamW
update. The JAX package's ``lax.scan`` over the microbatches is a Python
loop: each microbatch's gradients come from autograd
(``torch.autograd.grad``) and are added into float32 (``accum_dtype``)
accumulators, which are divided by the microbatch count before the update,
as there. The expert loads of an MoE model are summed over the
microbatches (not divided, as the JAX package's are not).

Autograd differentiates each stacked superblock leaf as its n_groups
slices (views of its storage), so a microbatch's gradient arrives a group
at a time and is added into the accumulator's slice: the full-size
gradient of a stacked leaf (2 GB in bfloat16 for each of granite-moe's
expert weights) never exists beside its slices. One microbatch stacks
the slices, as its update takes the gradients in the parameters' dtype.

On a mesh (``sharding.ctx.use_mesh``) both steps take DTensor
parameters laid out by ``sharding.rules.param_shardings``, caches by
``cache_shardings`` and optimizer state by ``opt_shardings``; a batch
tensor that is not a DTensor is laid out by the batch spec on the
parameters' mesh. Each
microbatch is a slice of the whole batch, pinned "dp" (the JAX package's
``constrain`` on each microbatch), so an MoE layer's capacity sees the
same tokens as without a mesh. The gradients, accumulators, moments and
masters keep the parameters' placements, and :func:`opt_update` runs on
the local shards; the step returns everything in the placements it was
given.

The JAX package's two ``REPRO_PERF_*`` flags of the step
(:mod:`repro_torch.flags`):

* ``BF16_ACCUM``, read when the step is made: the accumulators in
  bfloat16 whatever ``accum_dtype`` says.
* ``DEFER_GRAD_SYNC``, read at each call, on a mesh with microbatches:
  the parameters are gathered on the data axes once before the
  microbatch loop (:func:`_gathered_on_data`), so each microbatch's
  gradients arrive unreduced there (partial sums of the rank's batch
  shard, DTensor ``Partial``) and are added up locally; after the loop
  each is reduced once into its parameter's layout (a reduce-scatter of
  an FSDP-split leaf) instead of once per microbatch.

Not ported: the ``unroll`` argument of the scans (an XLA cost-analysis
tool; the loops here are Python loops).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict

import torch

from .. import flags
from ..models import forward, lm_loss, logits_from_hidden
from ..models.config import ModelConfig
from ..models.schema import tree_leaves, tree_map, tree_unflatten
from ..sharding import ctx as shard_ctx
from ..sharding.local import (DP_AXES, layout_batch, mesh_of,
                              unreduced_data_grads, wait_local)
from .optimizer import OptConfig, opt_update


def _leaf(p: torch.Tensor) -> torch.Tensor:
    """An autograd leaf sharing ``p``'s storage."""
    return p.detach().requires_grad_()


def _gathered_on_data(p):
    """The DTensor parameter ``p`` replicated on the data axes ("pod",
    "data"), laid out as before on the others."""
    from torch.distributed.tensor import Replicate
    names = p.device_mesh.mesh_dim_names
    want = [Replicate() if n in DP_AXES else pl
            for n, pl in zip(names, p.placements)]
    return p.redistribute(p.device_mesh, want) if want != list(
        p.placements) else p


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                    microbatches: int = 1, use_flash: bool = False,
                    collect_moe: bool = False, remat: bool = True,
                    accum_dtype: torch.dtype = torch.float32,
                    loss_chunks: int = 8):
    """Returns train_step(params, opt_state, batch, placements=None) ->
    (params, opt_state, metrics).

    ``batch`` is {"tokens", "labels"}, each (B, T) with B a multiple of
    ``microbatches``, and the arch's front-end input (``frames``,
    ``encoder_out`` or ``pixel_embeds``, batch-first), which goes to
    :func:`lm_loss` unchanged, split with the tokens. The step updates ``params`` and ``opt_state`` in place
    (:func:`opt_update`) and returns them. ``metrics`` holds 0-d tensors
    ``loss`` (the mean over the microbatches), ``grad_norm`` and ``lr``,
    and, with ``collect_moe`` on an MoE model, ``expert_load`` (n_groups,
    MoE sub-layers per superblock, E) by physical slot.

    ``use_flash=True`` raises ``NotImplementedError``: the flash kernel
    computes the forward only (the JAX package's has no VJP either), so
    training attention takes the plain path.
    """
    if use_flash:
        raise NotImplementedError(
            "the flash kernel has no backward pass; train with "
            "use_flash=False (the plain attention path)")
    moe = collect_moe and cfg.moe_experts > 0
    if flags.enabled("BF16_ACCUM"):
        accum_dtype = torch.bfloat16     # the JAX package's flag

    def grads_of(params, mb, placements):
        """The microbatch's loss, loads and gradients: one per leaf, or, for
        a stacked superblock leaf, a tuple of one per group."""
        with torch.enable_grad():
            live = {k: tree_map(_leaf, v) for k, v in params.items()
                    if k != "groups"}
            live["groups"] = tree_map(
                lambda a: tuple(_leaf(s) for s in a.unbind(0)),
                params["groups"])
            out = lm_loss(live, cfg, mb, placements=placements, remat=remat,
                          loss_chunks=loss_chunks, collect_moe=moe)
            loss, loads = out if moe else (out, None)
            leaves = tree_leaves(live)
            flat = [x for leaf in leaves for x in
                    (leaf if isinstance(leaf, tuple) else (leaf,))]
            flat_grads = iter(torch.autograd.grad(
                loss, flat, allow_unused=True, materialize_grads=True))
        grads = [tuple(next(flat_grads) for _ in leaf)
                 if isinstance(leaf, tuple) else next(flat_grads)
                 for leaf in leaves]
        return loss.detach(), loads, grads

    def train_step(params, opt_state, batch, placements=None):
        batch = layout_batch(batch, mesh_of(params["embed"]["tokens"]))
        if microbatches == 1:
            loss, loads, grads = grads_of(params, batch, placements)
            grads = [torch.stack(g) if isinstance(g, tuple) else g
                     for g in grads]
        else:
            b = batch["tokens"].shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} does not split into "
                                 f"{microbatches} microbatches")
            size = b // microbatches
            grads = [torch.zeros_like(p, dtype=accum_dtype)
                     for p in tree_leaves(params)]
            loss, loads = None, None
            whole = {k: shard_ctx.constrain(v, *([None] * v.dim()))
                     for k, v in batch.items()}
            defer = (flags.enabled("DEFER_GRAD_SYNC")
                     and mesh_of(params["embed"]["tokens"]) is not None)
            live = tree_map(_gathered_on_data, params) if defer else params
            unreduced = None
            for i in range(microbatches):
                mb = {k: shard_ctx.constrain(v[i * size:(i + 1) * size], "dp",
                                             *([None] * (v.dim() - 1)))
                      for k, v in whole.items()}
                with (unreduced_data_grads() if defer
                      else contextlib.nullcontext()):
                    mb_loss, mb_loads, mb_grads = grads_of(live, mb,
                                                           placements)
                if defer:
                    unreduced = _add_unreduced(unreduced, mb_grads,
                                               accum_dtype)
                else:
                    for acc, g in zip(grads, mb_grads):
                        for a, part in (zip(acc, g) if isinstance(g, tuple)
                                        else ((acc, g),)):
                            a.add_(part)
                del mb_grads
                loss = mb_loss if loss is None else loss + mb_loss
                if mb_loads is not None:
                    loads = mb_loads if loads is None else loads + mb_loads
            if defer:
                _reduce_into(grads, unreduced)
            for acc in grads:
                acc.div_(microbatches)
            loss = loss / microbatches
        params, opt_state, om = opt_update(tree_unflatten(params, grads),
                                           opt_state, params, opt_cfg)
        metrics: Dict[str, Any] = {"loss": loss, **om}
        if loads is not None:
            metrics["expert_load"] = loads
        return params, opt_state, metrics

    return train_step


def _add_unreduced(acc, grads, dtype):
    """Add one microbatch's DTensor gradients into ``acc``: per leaf, per
    gradient (the leaf's, or each group slice's of a stacked leaf) its
    placements, shape, stride and local sum so far in ``dtype`` (``acc``
    None: the first microbatch, zeros to start). No collective: a
    ``Partial`` gradient stays a local partial sum."""
    if acc is None:
        acc = [[(x.placements, x.shape, x.stride(),
                 torch.zeros_like(x.to_local(), dtype=dtype))
                for x in (g if isinstance(g, tuple) else (g,))]
               for g in grads]
    for leaf, g in zip(acc, grads):
        for (_, _, _, local), x in zip(
                leaf, g if isinstance(g, tuple) else (g,)):
            local.add_(wait_local(x))
    return acc


def _reduce_into(grads, acc) -> None:
    """Reduce each gradient :func:`_add_unreduced` accumulated, once, into
    its parameter's layout, and add it into ``grads`` (zero accumulators in
    the parameters' placements; a stacked leaf's a group slice at a
    time)."""
    from torch.distributed.tensor import DTensor
    for dst, leaf in zip(grads, acc):
        stacked = dst.dim() > len(leaf[0][1])
        for d, (placements, shape, stride, local) in zip(
                dst.unbind(0) if stacked else (dst,), leaf):
            total = DTensor.from_local(local, d.device_mesh, placements,
                                       run_check=False, shape=shape,
                                       stride=stride)
            d.add_(total.redistribute(d.device_mesh, d.placements))


def make_serve_step(cfg: ModelConfig, use_flash: bool = False):
    """Returns serve_step(params, cache, batch, index, placements=None) ->
    (logits (B, 1, V), cache): the next-token logits at the last position.
    T = prompt for prefill, 1 for decode; with ``cache=None`` a cache-free
    step over the whole prompt, where ``use_flash`` sends attention to the
    flash kernel. ``batch`` may carry the front end's input as
    :func:`forward` takes it (``frames``, ``encoder_out``,
    ``pixel_embeds``). ``placements`` (n_layers, E) places an MoE model's
    experts (``models.skewshield.placements_array``). The cache is updated
    in place and returned. On a mesh the logits are a DTensor pinned
    ("dp", None, "tp")."""

    def serve_step(params, cache, batch, index, placements=None):
        # DTensor's view ops set version counters, which inference-mode
        # tensors do not have: on a mesh the step runs under no_grad
        mode = (torch.inference_mode()
                if mesh_of(params["embed"]["tokens"]) is None
                else torch.no_grad())
        with mode:
            hidden, new_cache = forward(
                params, cfg, batch, cache=cache, cache_index=index,
                placements=placements, use_flash=use_flash, remat=False)
            logits = logits_from_hidden(params, cfg, hidden[:, -1:, :])
        return logits, new_cache

    return serve_step
