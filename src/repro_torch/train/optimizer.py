"""AdamW with float32 master weights, global-norm clipping and a
warmup-cosine schedule — the JAX package's ``train/optimizer.py``.

The optimizer state mirrors the parameter tree: ``{"m", "v", "master"}``
float32 trees and a 0-d int32 ``"step"``. The math and its order are the
JAX package's: the clip scale from the global gradient norm, the bias
corrections, decoupled weight decay on the float32 master, and the cast of
the master back to each parameter's dtype.

Unlike the JAX package's functional update, :func:`opt_update` writes the
moments, the master and the parameters **in place**, a slice of at most
``CHUNK`` elements at a time, under ``torch.no_grad()``. A stacked expert
leaf of granite-moe-3b-a800m holds 1.007 B elements (4.0 GB in float32);
an out-of-place update would need several such temporaries at once, and
the step would not fit on one 80 GB card. Each slice computes the JAX
package's expressions as written, so chunking changes no rounding.

:func:`opt_shardings` lays the state out on a mesh as the parameters are.
On DTensors (the train step under a mesh) the state mirrors the
parameters' placements, the update runs on each rank's local shards (AdamW
is elementwise), and :func:`global_norm` counts each shard once: a rank
adds a leaf's local sum of squares only where it holds the first copy of
that shard on every mesh dim the leaf is replicated over, and one
all-reduce sums the ranks' totals.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from ..models.schema import tree_leaves, tree_map

#: elements of a leaf that one slice of the update or the norm touches
CHUNK = 1 << 22


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a 0-d integer tensor), in float32."""
    step = step.to(torch.float32)
    warm = cfg.lr * torch.clamp((step + 1.0) / max(cfg.warmup_steps, 1),
                                max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * \
        (1.0 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def _dtensor_types():
    from torch.distributed.tensor import DTensor, Partial, Replicate
    return DTensor, Partial, Replicate


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (its storage), a tensor itself."""
    return t.to_local() if isinstance(t, _dtensor_types()[0]) else t


def opt_init(params) -> Dict[str, Any]:
    """Zero moments, a float32 copy of the parameters as the master, step
    0; every tensor on its parameter's device (DTensors in its placements,
    the step replicated)."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    first = tree_leaves(params)[0]
    step = torch.zeros((), dtype=torch.int32, device=first.device)
    DTensor, _, Replicate = _dtensor_types()
    if isinstance(first, DTensor):
        mesh = first.device_mesh
        step = DTensor.from_local(step, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "master": tree_map(lambda p: p.detach().to(torch.float32,
                                                   copy=True), params),
        "step": step,
    }


def _slices(t: torch.Tensor):
    flat = t.view(-1)
    for start in range(0, flat.numel(), CHUNK):
        yield flat[start:start + CHUNK]


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum, over the leaves in tree order, of each leaf's sum of
    squares in float32 (summed a slice at a time)."""
    leaves = tree_leaves(tree)
    DTensor, Partial, _ = _dtensor_types()
    mesh = (leaves[0].device_mesh if isinstance(leaves[0], DTensor)
            else None)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for leaf in leaves:
        if mesh is not None:
            if not _first_copy(leaf):
                continue
            leaf = leaf.to_local()
        total = total + sum(torch.sum(torch.square(s.to(torch.float32)))
                            for s in _slices(leaf.contiguous()))
    if mesh is not None:
        total = DTensor.from_local(total, mesh, [Partial()] * mesh.ndim,
                                   run_check=False).full_tensor()
    return torch.sqrt(total)


def _first_copy(leaf) -> bool:
    """Whether this rank holds the first copy of its shard of the DTensor
    ``leaf``: coordinate 0 on every mesh dim it is replicated over (a
    partial sum is refused: its local squares do not add up to the
    norm)."""
    if any(p.is_partial() for p in leaf.placements):
        raise ValueError(f"global_norm of a partial sum ({leaf.placements})")
    coord = leaf.device_mesh.get_coordinate()
    return all(c == 0 for c, p in zip(coord, leaf.placements)
               if p.is_replicate())


@torch.no_grad()
def opt_update(grads, opt_state, params, cfg: OptConfig
               ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step from ``grads`` (a tree like ``params``, any float
    dtype). Updates ``opt_state`` and ``params`` in place and returns them
    with ``{"grad_norm", "lr"}`` (0-d float32 tensors on the device). On
    DTensors every gradient must have its parameter's placements; the
    update writes the local shards."""
    leaves = [tree_leaves(x) for x in (grads, opt_state["m"], opt_state["v"],
                                       opt_state["master"], params)]
    for g_leaf, p_leaf in zip(leaves[0], leaves[-1]):
        if isinstance(p_leaf, _dtensor_types()[0]) and \
                tuple(g_leaf.placements) != tuple(p_leaf.placements):
            raise ValueError(f"a gradient in {g_leaf.placements} for a "
                             f"parameter in {p_leaf.placements}")
    step = _local(opt_state["step"])
    gnorm = global_norm(grads)
    clip = torch.tensor(cfg.grad_clip, dtype=torch.float32,
                        device=gnorm.device)
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr = schedule(cfg, step)
    t = (step + 1).to(torch.float32)
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)

    for g_leaf, m_leaf, v_leaf, w_leaf, p_leaf in zip(*leaves):
        for g, m, v, w, p in zip(*(_slices(_local(x)) for x in (
                g_leaf.contiguous(), m_leaf, v_leaf, w_leaf, p_leaf))):
            g = g.to(torch.float32) * scale
            m_new = cfg.b1 * m + (1 - cfg.b1) * g
            v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
            update = (m_new / bc1) / (torch.sqrt(v_new / bc2) + cfg.eps)
            w_new = w - lr * (update + cfg.weight_decay * w)
            m.copy_(m_new)
            v.copy_(v_new)
            w.copy_(w_new)
            p.copy_(w_new)                    # the cast to the param dtype
    opt_state["step"] = opt_state["step"] + 1
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}


def opt_shardings(param_shardings, mesh):
    """The optimizer state's layout: the moments and the master mirror the
    parameters' (a tree of :class:`~repro_torch.models.schema.Sharding`);
    ``step`` is replicated."""
    from ..models.schema import Sharding, placements_for
    return {"m": param_shardings, "v": param_shardings,
            "master": param_shardings,
            "step": Sharding(mesh, (), placements_for((), mesh))}
