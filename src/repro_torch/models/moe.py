"""Mixture-of-Experts layer with SkewShield expert placement — the JAX
package's ``models/moe.py``.

Dispatch is sort-based with a static capacity: gathers and batched matmuls,
no dynamic shapes, so nothing in it waits for the card.

  1. router top-k over logical experts (the router product in float32);
  2. **SkewShield**: logical expert ids go through a ``placement`` vector,
     the mixed routing function F(e) of paper Eq. 1 as an (E,) array;
  3. the flat (token, slot) entries are sorted stably by physical expert and
     each entry's rank in its expert is its sorted position minus the
     expert's first position (a left-side ``searchsorted``); entries ranked
     at or past the capacity are dropped;
  4. tokens are gathered into an (E, cap, D) buffer, the expert FFNs run as
     batched matmuls, and each (token, slot) entry gathers its expert's
     output back and is combined with its gate weight. The buffer's
     gather has a backward of its own (``_DispatchGather``): each token
     sums its k entries' gradients in slot order, so the gradient is the
     same on every call (ROADMAP C14).

**Dispatch groups** (``REPRO_PERF_MOE_GROUPED``, :func:`_dispatch_groups`).
With the flag set and a mesh installed, the N tokens split into G groups
of N / G contiguous tokens, G the product of the mesh's "pod" and "data"
sizes (1 where it does not divide N): each group sorts, ranks and fills
its own ``capacity_for(N / G)`` slots, as the JAX package's grouped
dispatch does, and on the mesh group g lives on data rank g, which routes
only its own tokens. Without the flag, or without a mesh, dispatch is one
group.

**Overflow, as the reference computes it on the CPU.** The JAX package
writes every entry of an expert into the slot ``min(rank, cap - 1)`` of its
dispatch buffer, dropped entries with the zero row's index. In an expert
whose count exceeds ``cap`` the dropped entries therefore land on the slot
of the entry ranked ``cap - 1``; the last write wins, so that entry reads
the zero row and gets 0 from its expert: such an expert keeps ``cap - 1``
tokens. A write with duplicate indices has no fixed winner on CUDA, so the
port computes the same result without one: it builds the dispatch buffer
by a gather and masks the entry ranked ``cap - 1`` out wherever the
expert's count exceeds ``cap``. ``dropped`` stays as the reference counts
it (entries ranked ``>= cap``), which does not count that extra drop.
"""

from __future__ import annotations

import contextlib
import math
import types
from typing import Optional

import torch
import torch.nn.functional as F

from .. import flags
from ..sharding import ctx as shard_ctx
from ..sharding.local import DP_AXES, Local, batch_split, replicated
from .config import ModelConfig
from .schema import ParamSpec


def moe_schema(cfg: ModelConfig, stack=()):
    st = tuple(["stack"] * len(stack))
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe_experts
    return {
        "router": ParamSpec(stack + (d, e), st + ("embed", None),
                            dtype=torch.float32),
        "w_gate": ParamSpec(stack + (e, d, f), st + ("expert", "embed", "mlp")),
        "w_up": ParamSpec(stack + (e, d, f), st + ("expert", "embed", "mlp")),
        "w_down": ParamSpec(stack + (e, f, d), st + ("expert", "mlp", "embed")),
    }


def capacity_for(n_tokens: int, cfg: ModelConfig) -> int:
    cap = int(math.ceil(n_tokens * cfg.moe_topk * cfg.moe_capacity_factor
                        / cfg.moe_experts))
    return max(8, ((cap + 7) // 8) * 8)


#: a group count fixed by :func:`fixed_groups`, or None
_groups = types.SimpleNamespace(fixed=None)


@contextlib.contextmanager
def fixed_groups(g: int):
    """Within the block, dispatch in ``g`` groups (where ``g`` divides the
    token count) whatever the flag and the mesh: the grouped layer without
    a mesh, the oracle a sharded grouped step is held against."""
    prev = _groups.fixed
    _groups.fixed = g
    try:
        yield
    finally:
        _groups.fixed = prev


def _dispatch_groups(n_tokens: int) -> int:
    """The dispatch-group count: the data-parallel degree of the installed
    mesh (the product of its "pod" and "data" sizes) with
    ``REPRO_PERF_MOE_GROUPED`` set, where it divides ``n_tokens``; else 1
    (the JAX package's ``_dispatch_groups``)."""
    g = _groups.fixed
    if g is None:
        if not flags.enabled("MOE_GROUPED"):
            return 1
        mesh = shard_ctx.current_mesh()
        if mesh is None:
            return 1
        names = tuple(mesh.mesh_dim_names)
        g = math.prod(int(mesh.size(names.index(a)))
                      for a in DP_AXES if a in names)
    return g if n_tokens % g == 0 else 1


def _served(rank: torch.Tensor, count: torch.Tensor, cap: int
            ) -> torch.Tensor:
    """Which entries reach their expert: ranked below ``cap``, less the one
    ranked ``cap - 1`` in an expert whose ``count`` exceeds ``cap`` (see the
    module docstring)."""
    return (rank < cap) & ~((rank == cap - 1) & (count > cap))


class _DispatchGather(torch.autograd.Function):
    """``x_pad[dispatch]``: the (E, cap, D) dispatch buffer gathered from the
    N token rows of ``xf`` and a zero row (index N).

    Its backward gathers each token's k entries from the buffer's gradient
    through their positions ``pos`` (N, k) and sums them in slot order,
    where ``served`` (N, k) is false: a gather and a fixed-order sum.
    Autograd's own backward of the gather scatter-adds a token's copies
    with atomic float adds on the CPU, whose order, and so whose last bit,
    changes from call to call."""

    @staticmethod
    def forward(ctx, xf, dispatch, pos, served):
        ctx.save_for_backward(pos, served)
        x_pad = torch.cat([xf, xf.new_zeros(1, xf.shape[1])])
        return x_pad[dispatch]

    @staticmethod
    def backward(ctx, grad):
        pos, served = ctx.saved_tensors
        parts = grad.reshape(-1, grad.shape[-1])[pos]           # (N, k, D)
        parts = torch.where(served[..., None], parts, parts.new_zeros(()))
        return parts.sum(dim=1), None, None, None


def _route(router, cfg: ModelConfig, xf: torch.Tensor,
           placement: Optional[torch.Tensor],
           gates: Optional[torch.Tensor] = None) -> dict:
    """Steps 1-3 and the dispatch buffer's gather over the N token rows of
    ``xf``: {"xs": (E, cap, D), "weights": (N, k) gate weights, "src":
    each (token, slot) entry's row in the flat buffer, "entry_served",
    "count": entries per physical slot, "rank_sorted"}. ``gates`` (N, E),
    when given, are the router's logits (else ``xf @ router`` in
    float32)."""
    n, d = xf.shape
    e, k = cfg.moe_experts, cfg.moe_topk
    nk = n * k
    cap = capacity_for(n, cfg)
    dev = xf.device

    if gates is None:
        gates = xf.to(torch.float32) @ router                # (N, E)
    top_vals, top_idx = torch.topk(gates, k, dim=-1)         # (N, k)
    weights = torch.softmax(top_vals, dim=-1)

    flat_e = top_idx.reshape(nk)
    if placement is not None:
        flat_e = placement.to(device=dev, dtype=torch.long)[flat_e]

    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    experts = torch.arange(e, device=dev)
    starts = torch.searchsorted(sorted_e, experts)
    count = torch.searchsorted(sorted_e, experts, right=True) - starts
    rank_sorted = torch.arange(nk, device=dev) - starts[sorted_e]

    # dispatch: slot r of expert x holds the entry at sorted position
    # starts[x] + r, or the zero row (index n) where no entry is served
    slot_rank = torch.arange(cap, device=dev)
    pos = (starts[:, None] + slot_rank).clamp_(max=nk - 1)   # (E, cap)
    served = (slot_rank < count[:, None]) & \
        _served(slot_rank, count[:, None], cap)
    dispatch = torch.where(served, order[pos] // k, n)
    # each (token, slot) entry's place in the buffer, and whether it is
    # served there
    rank_of = torch.empty_like(rank_sorted)
    rank_of[order] = rank_sorted                 # a permutation: no repeats
    src = flat_e * cap + rank_of.clamp(max=cap - 1)
    entry_served = _served(rank_of, count[flat_e], cap)
    xs = _DispatchGather.apply(xf, dispatch, src.reshape(n, k),
                               entry_served.reshape(n, k))  # (E, cap, D)
    return {"xs": xs, "weights": weights, "src": src,
            "entry_served": entry_served, "count": count,
            "rank_sorted": rank_sorted}


def _experts(p, xs: torch.Tensor) -> torch.Tensor:
    """The expert FFNs over the (E, cap, D) buffer, batched."""
    gate_h = F.silu(torch.bmm(xs, p["w_gate"]))
    up_h = torch.bmm(xs, p["w_up"])
    return torch.bmm(gate_h * up_h, p["w_down"])             # (E, cap, D)


def _combine(ys: torch.Tensor, r: dict, k: int) -> torch.Tensor:
    """Each (token, slot) entry gathers its expert's output back, weighted
    by its gate; (N, D)."""
    e, cap, d = ys.shape
    y_tok = ys.reshape(e * cap, d)[r["src"]]
    y_tok = torch.where(r["entry_served"][:, None], y_tok,
                        y_tok.new_zeros(()))
    return (y_tok.reshape(-1, k, d) * r["weights"][..., None].to(y_tok.dtype)
            ).sum(dim=1)


def moe(p, cfg: ModelConfig, x: torch.Tensor,
        placement: Optional[torch.Tensor] = None,
        return_stats: bool = False):
    """x: (B, T, D) -> (B, T, D) [, stats].

    placement: (E,) integer tensor on ``x``'s device, the physical slot of
    each logical expert (SkewShield F(e); None = the identity). The expert
    weights are stored by physical slot. With ``return_stats`` also returns
    ``{"expert_load": (E,) float32 entries per physical slot, "dropped":
    entries ranked >= cap}``, each summed over the dispatch groups.

    ``x`` and ``p`` may be DTensors on a mesh (ROADMAP A7b); the layer
    then carries the JAX package's pins on its (G, N / G, D) dispatch
    groups (:func:`_dispatch_groups`), and on plain tensors every pin and
    layout below is the identity:

    * with one group, the (1, N, D) tokens are pinned "dp" on the size-1
      group dim, which resolves to replicated (or a split over data axes
      of size 1): every rank routes all N tokens, so the capacity, the
      top-k, the stable sort and ``_served`` see the whole batch, as the
      unsharded layer does, and the routing is the same. None of these ops (nor
      ``_DispatchGather``) has a DTensor sharding strategy; they run as
      one local call on the replicated tokens and router.
    * with G groups (``REPRO_PERF_MOE_GROUPED``), the group dim is pinned
      "dp": group g lives on data rank g, which routes only its own N / G
      tokens (taken from its batch shard where the batch splits over the
      data axes) and combines them locally.
    * the dispatch buffer ``xs`` and the expert outputs ``ys`` are pinned
      ("dp", "tp"): the experts split over "model" where E divides
      (expert parallelism; each rank runs its experts' FFNs on its slice
      of the buffer, with the expert weights gathered on the data axes),
      replicated otherwise.
    * the combine gathers ``ys`` over "model" and runs on the rank's
      groups; ``out`` is pinned "dp", back to the batch split.
    """
    k = cfg.moe_topk
    g = _dispatch_groups(x.shape[0] * x.shape[1])
    constrain = shard_ctx.constrain
    xg = constrain(_to_groups(x, g), "dp", None, None)      # (G, Ng, D)
    loc = Local.of(xg)
    router = loc.param(p["router"])
    routes = [_route(router, cfg, xi, placement) for xi in loc.act(xg)]
    xs = torch.stack([r.pop("xs") for r in routes])        # (G, E, cap, D)
    xs = constrain(loc.out(xs), "dp", "tp", None, None)
    ep = Local.of(xs)
    split = any(getattr(pl, "dim", None) == 1
                for pl in getattr(xs, "placements", ()))
    cols = 1 if split else None
    w = {name: ep.param(p[name], 0 if split else None)
         for name in ("w_gate", "w_up", "w_down")}
    ys = torch.stack([_experts(w, xi)
                      for xi in ep.act(xs, model_dim=cols)])
    ys = constrain(ep.out(ys, model_dim=cols), "dp", "tp", None, None)
    out = torch.stack([_combine(yi, r, k)
                       for yi, r in zip(loc.act(ys), routes)])
    out = constrain(_from_groups(constrain(loc.out(out), "dp", None, None),
                                 x), "dp", None, None)
    if not return_stats:
        return out
    cap = capacity_for(x.shape[0] * x.shape[1] // g, cfg)
    load = torch.stack([r["count"] for r in routes]).sum(0)
    dropped = torch.stack([(r["rank_sorted"] >= cap).sum() for r in routes])
    return out, {"expert_load": loc.total(load.to(torch.float32)),
                 "dropped": loc.total(dropped.sum())}


def _by_group(x, g: int) -> bool:
    """Whether ``x``'s batch shard is one dispatch group: the DTensor ``x``
    splits its batch over every data axis of its mesh, G ways."""
    if getattr(x, "device_mesh", None) is None:
        return False
    names = tuple(x.device_mesh.mesh_dim_names)
    dp = [i for i, a in enumerate(names) if a in DP_AXES]
    split = batch_split(x)
    return (bool(dp) and all(split[i] for i in dp)
            and math.prod(int(x.device_mesh.size(i)) for i in dp) == g)


def _to_groups(x, g: int):
    """(B, T, D) -> (G, N / G, D), group i the flat tokens [i N / G,
    (i + 1) N / G), pinned "dp": each rank's own batch rows where its batch
    shard is one group, else cut from the whole batch."""
    b, t, d = x.shape
    ng = b * t // g
    if _by_group(x, g):
        loc = Local.of(x)
        return loc.out(loc.act(x).reshape(-1, ng, d))
    whole = replicated(x)
    rep = Local.of(whole)
    return shard_ctx.constrain(rep.out(rep.act(whole).reshape(g, ng, d)),
                               "dp", None, None)


def _from_groups(out, like):
    """:func:`_to_groups` inverted: (G, N / G, D) back to ``like``'s (B, T,
    D), pinned "dp"."""
    b, t, d = like.shape
    if _by_group(like, out.shape[0]):
        return Local.of(like).out(Local.of(out).act(out).reshape(-1, t, d))
    whole = replicated(out)
    rep = Local.of(whole)
    return shard_ctx.constrain(rep.out(rep.act(whole).reshape(b, t, d)),
                               "dp", None, None)


def moe_stationary(p, cfg: ModelConfig, hs: torch.Tensor, mesh,
                   placement: Optional[torch.Tensor] = None,
                   return_stats: bool = False):
    """:func:`moe` in the weight-stationary decode layout
    (``REPRO_PERF_DECODE_WS``, ``models.transformer``): ``hs`` (B, T,
    D / data) is this rank's slice of the normed activation's embed dim,
    all B rows; returns this rank's slice of the layer's output (B, T,
    D / data) [, stats], a plain tensor.

    Every weight stays in its FSDP layout on "data": the router's logits
    and the expert FFNs' first products sum this rank's partial products
    over "data" (activation-sized all-reduces), the second product gives
    this rank's embed slice. Each rank routes all the tokens, in the
    dispatch groups :func:`_dispatch_groups` gives, so the routing is the
    grouped layer's; the experts split over "model" where E divides, and
    their outputs are gathered there for the combine."""
    from ..sharding.local import (MODEL_AXIS, axis_gather, axis_sum,
                                  model_size, stationary)
    b, t, dl = hs.shape
    e, k = cfg.moe_experts, cfg.moe_topk
    g = _dispatch_groups(b * t)
    ng = b * t // g
    router = stationary(p["router"])                        # (D/data, E)
    routes = []
    for xi in hs.reshape(g, ng, dl):
        gates = axis_sum(xi.to(torch.float32) @ router, mesh)
        routes.append(_route(None, cfg, xi, placement, gates=gates))
    xs = torch.stack([r.pop("xs") for r in routes])    # (G, E, cap, D/data)
    m = model_size(mesh)
    split = m > 1 and e % m == 0
    if split:
        el = e // m
        xs = xs[:, int(mesh.get_local_rank(MODEL_AXIS)) * el:][:, :el]
    w = {name: stationary(p[name], 0 if split else None)
         for name in ("w_gate", "w_up", "w_down")}
    ys = []
    for xi in xs:
        gate_h = F.silu(axis_sum(torch.bmm(xi, w["w_gate"]), mesh))
        up_h = axis_sum(torch.bmm(xi, w["w_up"]), mesh)
        ys.append(torch.bmm(gate_h * up_h, w["w_down"]))
    ys = torch.stack(ys)                           # (G, E_local, cap, D/data)
    if split:
        ys = axis_gather(ys, mesh, MODEL_AXIS, 1)     # (G, E, cap, D/data)
    out = torch.stack([_combine(yi, r, k) for yi, r in zip(ys, routes)])
    out = out.reshape(b, t, dl)
    if not return_stats:
        return out
    cap = capacity_for(ng, cfg)
    return out, {"expert_load": torch.stack(
                     [r["count"] for r in routes]).sum(0).to(torch.float32),
                 "dropped": sum((r["rank_sorted"] >= cap).sum()
                                for r in routes)}


def aux_load_balance_loss(gates_softmax: torch.Tensor, top_idx: torch.Tensor,
                          e: int) -> torch.Tensor:
    """Switch-style auxiliary loss (the *long-term* fix the paper contrasts
    with; kept for completeness/ablation)."""
    me = torch.mean(gates_softmax, dim=0)
    idx = top_idx.reshape(-1).to(torch.long)
    ce = torch.zeros(e, dtype=torch.float32, device=idx.device).index_add_(
        0, idx, torch.ones(idx.shape, dtype=torch.float32, device=idx.device))
    ce = ce / torch.clamp(ce.sum(), min=1.0)
    return e * torch.sum(me * ce)
