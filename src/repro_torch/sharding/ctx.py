"""Activation-sharding constraint context — the JAX package's
``sharding/ctx.py``.

``constrain(x, "dp", None, "tp")`` names a logical axis per dim. It
redistributes the DTensor ``x`` on its own mesh to the placements those
names resolve to, each mesh axis used by one dim at most (a later dim that
resolves to a used axis is replicated), as the JAX package's
``with_sharding_constraint`` pins do; a plain tensor comes back as it is,
and under :func:`use_mesh` is refused. So a pin never reads the installed
mesh for a DTensor, and the recomputes of a backward pass (remat's and the
loss chunks' ``checkpoint``) lay out their DTensors as their forward did,
wherever that backward runs.

The models call it at the JAX package's unconditional call sites (the
embedded and hidden state, each loss chunk and its logits, the MoE
dispatch buffers, each microbatch); ``models.transformer`` runs the layers
between those pins on each rank's shards.
"""

from __future__ import annotations

import contextlib
import math
import types
from typing import Optional

from ..models.schema import mesh_axes, placements_for

#: the installed mesh, for the whole process (the JAX package keeps it per
#: thread; here the autograd engine runs a CUDA backward on its own device
#: threads)
_state = types.SimpleNamespace(mesh=None)

LOGICAL = {
    "dp": ("pod", "data"),        # batch-like dims
    "tp": ("model",),             # tensor/expert-parallel dims
    "sp": ("data",),              # sequence-parallel dims
}


def current_mesh():
    return _state.mesh


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
    dim. The DTensor ``x`` redistributed on its mesh to the resolved
    layout; a plain ``x`` itself, outside :func:`use_mesh`."""
    from .local import is_dtensor
    if not is_dtensor(x):
        if current_mesh() is not None:
            raise TypeError("constrain under a mesh takes a DTensor: lay "
                            "the parameters and the batch out on the mesh "
                            "first")
        return x
    mesh = x.device_mesh
    spec = resolve_spec(mesh, x.shape, parts)
    return x.redistribute(mesh, list(placements_for(spec, mesh)))
