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

Dispatch is one group. The JAX package splits it into one group per data
shard only when ``REPRO_PERF_MOE_GROUPED`` is set and a mesh is installed
(``_dispatch_groups``); that XLA sharding path is not ported, by decision.

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

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..sharding import ctx as shard_ctx
from ..sharding.local import Local, replicated
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
           placement: Optional[torch.Tensor]) -> dict:
    """Steps 1-3 and the dispatch buffer's gather over the N token rows of
    ``xf``: {"xs": (E, cap, D), "weights": (N, k) gate weights, "src":
    each (token, slot) entry's row in the flat buffer, "entry_served",
    "count": entries per physical slot, "rank_sorted"}."""
    n, d = xf.shape
    e, k = cfg.moe_experts, cfg.moe_topk
    nk = n * k
    cap = capacity_for(n, cfg)
    dev = xf.device

    gates = xf.to(torch.float32) @ router                    # (N, E)
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


def _stats(r: dict, cap: int) -> dict:
    return {"expert_load": r["count"].to(torch.float32),
            "dropped": (r["rank_sorted"] >= cap).sum()}


def moe(p, cfg: ModelConfig, x: torch.Tensor,
        placement: Optional[torch.Tensor] = None,
        return_stats: bool = False):
    """x: (B, T, D) -> (B, T, D) [, stats].

    placement: (E,) integer tensor on ``x``'s device, the physical slot of
    each logical expert (SkewShield F(e); None = the identity). The expert
    weights are stored by physical slot. With ``return_stats`` also returns
    ``{"expert_load": (E,) float32 entries per physical slot, "dropped":
    entries ranked >= cap}``.

    ``x`` and ``p`` may be DTensors on a mesh (ROADMAP A7b); the layer
    then carries the JAX package's pins on its one dispatch group (the
    leading dim of 1 here as there), and on plain tensors every pin and
    layout below is the identity:

    * ``xf`` is pinned "dp" on the size-1 group dim, which resolves to
      replicated (or a split over data axes of size 1): every rank routes
      all N tokens, so the capacity, the top-k, the stable sort and
      ``_served`` see the whole batch, as the unsharded layer does, and
      the routing is the same. None of these ops (nor ``_DispatchGather``)
      has a DTensor sharding strategy; they run as one local call on the
      replicated tokens and router.
    * the dispatch buffer ``xs`` and the expert outputs ``ys`` are pinned
      ("dp", "tp"): the experts split over "model" where E divides
      (expert parallelism; each rank runs its experts' FFNs on its slice
      of the buffer, with the expert weights gathered on the data axes),
      replicated otherwise.
    * the combine gathers ``ys`` (an all-gather over "model") and runs
      replicated; ``out`` is pinned "dp", back to the batch split.
    """
    constrain = shard_ctx.constrain
    b, t, d = x.shape
    n, k = b * t, cfg.moe_topk

    def reshaped(a, *shape):
        # DTensor refuses a view that merges or splits a sharded dim, so
        # the reshapes run on each rank's (replicated) shard
        loc = Local.of(a)
        return loc.out(loc.act(a).reshape(*shape))

    xf = constrain(reshaped(replicated(x), 1, n, d), "dp", None, None)
    rep = Local.of(xf)
    r = _route(rep.param(p["router"]), cfg, rep.act(xf)[0], placement)
    xs = constrain(rep.out(r.pop("xs")[None]), "dp", "tp", None, None)
    ep = Local.of(xs)
    split = any(getattr(pl, "dim", None) == 1
                for pl in getattr(xs, "placements", ()))
    cols = 1 if split else None
    ys = _experts({name: ep.param(p[name], 0 if split else None)
                   for name in ("w_gate", "w_up", "w_down")},
                  ep.act(xs, model_dim=cols)[0])
    ys = constrain(ep.out(ys[None], model_dim=cols), "dp", "tp", None, None)
    out = _combine(rep.act(replicated(ys))[0], r, k)
    out = constrain(rep.out(out[None]), "dp", None, None)
    out = constrain(reshaped(out, b, t, d), "dp", None, None)
    if return_stats:
        return out, _stats(r, capacity_for(n, cfg))
    return out


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
