"""Logical-axis -> mesh-axis sharding rules for params, caches and data —
the JAX package's ``sharding/rules.py``.

Parameter 2-D sharding (TP x FSDP): the tensor-parallel logical axes (vocab,
q_heads, kv_flat, mlp, expert, mamba_inner) map to "model"; the d_model
("embed") axis maps to "data", ZeRO-3-style parameter sharding. A dim
whose size its axes do not divide is replicated and listed by
:func:`replication_report`.

The batch shards over (pod, data); for a global batch below the DP degree
it is replicated and the KV sequence ("kv_seq") shards over "data" instead,
sequence parallelism for the cache.

The ``*_pspecs`` functions and :func:`batch_pspec` read only a mesh's axis
names and sizes (:func:`~repro_torch.models.schema.mesh_axes`); the
``*_shardings`` functions and :func:`batch_sharding` need a ``DeviceMesh``
and return :class:`~repro_torch.models.schema.Sharding` (DTensor
placements).
"""

from __future__ import annotations

import math

from ..models import schema as schema_mod

PARAM_RULES = {
    "vocab": "model",
    "q_heads": "model",
    "kv_flat": "model",
    "mlp": "model",
    "expert": "model",
    "mamba_inner": "model",
    "heads": "model",
    "embed": "data",            # FSDP over the data axis
    "stack": None,
    "conv": None,
    None: None,
}

PARAM_RULES_NO_FSDP = {**PARAM_RULES, "embed": None}


def _dp_axes(mesh) -> tuple:
    names = schema_mod.mesh_axes(mesh).axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def dp_degree(mesh) -> int:
    shape = schema_mod.mesh_axes(mesh).shape
    return int(math.prod(int(shape[a]) for a in _dp_axes(mesh)))


def _param_rules(fsdp: bool) -> dict:
    return PARAM_RULES if fsdp else PARAM_RULES_NO_FSDP


def param_shardings(model_schema, mesh, fsdp: bool = True):
    return schema_mod.shardings(model_schema, mesh, _param_rules(fsdp))


def param_pspecs(model_schema, mesh, fsdp: bool = True):
    return schema_mod.partition_specs(model_schema, mesh, _param_rules(fsdp))


def batch_pspec(mesh, global_batch: int) -> tuple:
    if global_batch % dp_degree(mesh) == 0:
        return (schema_mod.spec_entry(_dp_axes(mesh)), None)
    return (None, None)


def batch_sharding(mesh, global_batch: int) -> schema_mod.Sharding:
    spec = batch_pspec(mesh, global_batch)
    return schema_mod.Sharding(mesh, spec,
                               schema_mod.placements_for(spec, mesh))


def cache_rules(mesh, global_batch: int) -> dict:
    """KV-cache logical axes; the SP fallback for an unshardable batch."""
    dp = _dp_axes(mesh)
    batch_ok = global_batch % dp_degree(mesh) == 0
    return {
        **PARAM_RULES,
        "embed": None,                       # cache activations: no FSDP
        "batch": dp if batch_ok else None,
        "kv_seq": None if batch_ok else "data",   # sequence-parallel cache
    }


def cache_shardings(cache_schema, mesh, global_batch: int):
    return schema_mod.shardings(cache_schema, mesh,
                                cache_rules(mesh, global_batch))


def cache_pspecs(cache_schema, mesh, global_batch: int):
    return schema_mod.partition_specs(cache_schema, mesh,
                                      cache_rules(mesh, global_batch))


def replication_report(model_schema, mesh, fsdp: bool = True) -> dict:
    return schema_mod.replication_report(model_schema, mesh,
                                         _param_rules(fsdp))
