"""Activation-sharding constraint context — the JAX package's
``sharding/ctx.py``.

``constrain(x, "dp", None, "tp")`` names a logical axis per dim. With no
mesh installed it returns ``x``; under :func:`use_mesh` it redistributes
the DTensor ``x`` to the placements those names resolve to, each mesh axis
used by one dim at most (a later dim that resolves to a used axis is
replicated), as the JAX package's ``with_sharding_constraint`` pins do.

The port's models do not call it yet: running their forward on DTensors
under a mesh is a later slice (ROADMAP A7b).
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

from ..models.schema import mesh_axes, placements_for

_state = threading.local()

LOGICAL = {
    "dp": ("pod", "data"),        # batch-like dims
    "tp": ("model",),             # tensor/expert-parallel dims
    "sp": ("data",),              # sequence-parallel dims
}


def current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


def _resolve(mesh, name, size: Optional[int]):
    if name is None:
        return None
    view = mesh_axes(mesh)
    axes = tuple(a for a in LOGICAL.get(name, (name,))
                 if a in view.axis_names)
    if not axes:
        return None
    if size is not None:
        if size % math.prod(int(view.shape[a]) for a in axes) != 0:
            return None
    return axes if len(axes) > 1 else axes[0]


def resolve_spec(mesh, shape, parts) -> tuple:
    """The spec ``constrain`` lays a tensor of ``shape`` out by: each
    logical name resolved (:func:`_resolve`), then a dim whose axes an
    earlier dim took replicated."""
    if len(parts) != len(shape):
        raise ValueError(f"{len(parts)} axis names for a tensor of shape "
                         f"{tuple(shape)}")
    used, final = set(), []
    for i, p in enumerate(parts):
        r = _resolve(mesh, p, shape[i])
        key = tuple(r) if isinstance(r, tuple) else (r,)
        if r is None or any(k in used for k in key):
            final.append(None)
            continue
        used.update(key)
        final.append(r)
    return tuple(final)


def constrain(x, *parts):
    """parts: a logical name ('dp' | 'tp' | 'sp' | a mesh axis | None) per
    dim. ``x`` itself without a mesh; under one, the DTensor ``x``
    redistributed to the resolved layout."""
    mesh = current_mesh()
    if mesh is None:
        return x
    spec = resolve_spec(mesh, x.shape, parts)
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        raise TypeError("constrain under a mesh takes a DTensor (the model "
                        "forward on DTensors is not ported yet)")
    return x.redistribute(mesh, list(placements_for(spec, mesh)))
