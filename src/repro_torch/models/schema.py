"""Declarative parameter schemas, as in the JAX package's ``models/schema.py``.

Every model builds a tree (nested dicts) of :class:`ParamSpec`, a pure
function of its config; :func:`init` materialises it with random weights and
:func:`count_params` sizes it. The logical axis names are kept so a
parameter tree converts one-to-one from the JAX package's.

Sharding: :func:`spec_for`, :func:`partition_specs` and
:func:`replication_report` map logical axes to mesh axes through a rules
dict, with the JAX package's divisibility fallback; they read only a mesh's
axis names and sizes (:func:`mesh_axes`), so a
``torch.distributed.device_mesh.DeviceMesh`` and a stand-in with ``shape``
and ``axis_names`` both serve. A spec is a tuple with one entry per dim:
``None``, a mesh axis name, or a tuple of names (the dim split over those
axes, the first major), as a JAX ``PartitionSpec`` holds them.
:func:`shardings` turns each spec into DTensor placements on a
``DeviceMesh`` (:class:`Sharding`).
"""

from __future__ import annotations

import dataclasses
import math
import types
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]        # logical axis name per dim
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"                   # normal | zeros | ones
    scale: Optional[float] = None          # None -> 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             "differ in rank")


def tree_map(fn, tree):
    """``fn`` over the leaves of a nested dict, in sorted key order (the
    order the JAX package's pytrees flatten in)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def tree_paths(tree, prefix: str = "") -> list:
    """(path, leaf) pairs of a nested dict in :func:`tree_map`'s order, each
    path written as the JAX package's ``keystr`` writes a dict path
    (``['opt']['m']['embed']['tokens']``)."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_paths(tree[k], f"{prefix}[{k!r}]")]
    return [(prefix, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_unflatten(like, leaves):
    """The tree of ``like``'s structure holding ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


#: leaves larger than this are drawn a slice of their first dim at a time
SLICED_INIT_ELEMENTS = 1 << 32


def _materialize(spec: ParamSpec, generator: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    # the JAX package's rule, kept as is: the first dim, which for a stacked
    # (n_groups, ...) weight is n_groups (std 1/sqrt(8) for gemma3-12b)
    fan_in = spec.shape[0] if len(spec.shape) > 1 else max(spec.shape[-1], 1)
    scale = spec.scale if spec.scale is not None else 1.0 / math.sqrt(fan_in)
    if math.prod(spec.shape) <= SLICED_INIT_ELEMENTS or len(spec.shape) < 2:
        w = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return w.mul_(scale).to(spec.dtype)
    # one float32 draw of the whole leaf would not fit beside the model on
    # one card (granite-20b's MLP leaves: 31 GB each), so draw a slice of
    # the first dim at a time
    out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
    for part in out:
        part.copy_(torch.randn(part.shape, generator=generator,
                               dtype=torch.float32, device=device).mul_(scale))
    return out


def init(schema, generator: torch.Generator, device) -> dict:
    """Random weights for ``schema``: normal x 1/sqrt(fan_in) (or the spec's
    scale), ones and zeros where the spec says, drawn from ``generator`` (a
    generator of ``device``'s type) in float32 and cast to each spec's
    dtype."""
    device = torch.device(device)
    return tree_map(lambda s: _materialize(s, generator, device), schema)


def count_params(schema) -> int:
    sizes = []
    tree_map(lambda s: sizes.append(math.prod(s.shape)), schema)
    return int(sum(sizes))


# -- sharding: logical axes -> mesh axes -------------------------------------

#: default logical-axis -> mesh-axis rules (the TP/EP mapping)
DEFAULT_RULES = {
    "vocab": "model",
    "q_heads": "model",
    "kv_flat": "model",
    "mlp": "model",
    "expert": "model",
    "mamba_inner": "model",
    "heads": "model",
    "embed": None,            # d_model replicated (TP on the other operand)
    "stack": None,
    "conv": None,
    None: None,
}


def mesh_axes(mesh):
    """``mesh``'s axis names and a name -> size mapping: a ``DeviceMesh``'s
    ``mesh_dim_names`` and ``shape``, or any object that has ``axis_names``
    and a ``shape`` mapping (a JAX mesh's surface)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return mesh
    return types.SimpleNamespace(axis_names=tuple(names),
                                 shape=dict(zip(names, mesh.shape)))


def spec_entry(axes):
    """One spec entry as a JAX ``PartitionSpec`` holds it: an empty tuple
    of axes is ``None``, a one-axis tuple its name."""
    if isinstance(axes, tuple) and len(axes) < 2:
        return axes[0] if axes else None
    return axes


def spec_for(spec: ParamSpec, mesh, rules=None) -> tuple:
    """Logical axes -> a spec with the divisibility fallback: a dim shards
    only if its size divides the product of its mesh axes and no earlier
    dim took the same axis; otherwise it is replicated, and
    :func:`replication_report` lists it."""
    axes = mesh_axes(mesh)
    rules = {**DEFAULT_RULES, **(rules or {})}
    out, used = [], set()
    for size, axis in zip(spec.shape, spec.axes):
        mesh_axis = rules.get(axis)
        if mesh_axis is None or mesh_axis in used:
            out.append(None)
            continue
        names = mesh_axis if isinstance(mesh_axis, tuple) else (mesh_axis,)
        if size % math.prod(int(axes.shape[a]) for a in names) == 0:
            out.append(spec_entry(mesh_axis))
            used.add(mesh_axis)
        else:
            out.append(None)
    return tuple(out)


def partition_specs(schema, mesh, rules=None):
    return tree_map(lambda s: spec_for(s, mesh, rules), schema)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec laid out on a ``DeviceMesh``: one DTensor placement per mesh
    dim (the JAX package's ``NamedSharding``)."""

    mesh: object
    spec: tuple
    placements: tuple

    def distribute(self, tensor):
        """``tensor`` (the same on every rank) as a DTensor of this
        layout."""
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(tensor, self.mesh, list(self.placements))


def placements_for(spec: tuple, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dim that tensor dim ``d`` is split over, ``Replicate()`` on the others.
    DTensor splits a dim over several mesh dims major to minor in the
    mesh's order, and JAX in the spec entry's order, so an entry that lists
    its axes in another order than the mesh raises."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh_axes(mesh).axis_names
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        group = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} splits dim {dim} in an "
                             f"order other than the mesh's {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def shardings(schema, mesh, rules=None):
    """A :class:`Sharding` per leaf of ``schema`` on the ``DeviceMesh``
    ``mesh``."""
    def one(s):
        spec = spec_for(s, mesh, rules)
        return Sharding(mesh, spec, placements_for(spec, mesh))
    return tree_map(one, schema)


def distribute(tree, shardings_tree):
    """The tensors of ``tree`` (the same on every rank) as DTensors, each
    laid out by its :class:`Sharding` in ``shardings_tree``."""
    return tree_unflatten(tree, [
        s.distribute(t) for t, s in zip(tree_leaves(tree),
                                        tree_leaves(shardings_tree))])


def replication_report(schema, mesh, rules=None) -> dict:
    """Which logical axes failed divisibility and were replicated, with
    their sizes (the JAX package's roofline notes)."""
    report = {}

    def visit(s):
        for size, logical, assigned in zip(s.shape, s.axes,
                                           spec_for(s, mesh, rules)):
            if logical not in (None, "stack", "embed", "conv") \
                    and assigned is None:
                report.setdefault(logical, set()).add(size)

    tree_map(visit, schema)
    return {k: sorted(v) for k, v in report.items()}
