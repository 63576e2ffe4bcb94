"""Declarative parameter schemas, as in the JAX package's ``models/schema.py``.

Every model builds a tree (nested dicts) of :class:`ParamSpec`, a pure
function of its config; :func:`init` materialises it with random weights and
:func:`count_params` sizes it. The logical axis names are kept so a
parameter tree converts one-to-one from the JAX package's; the sharding
functions come with the sharded slice.
"""

from __future__ import annotations

import dataclasses
import math
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
    w = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return w.mul_(scale).to(spec.dtype)


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
