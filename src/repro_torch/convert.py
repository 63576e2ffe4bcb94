"""Carry state and weights across from the JAX package.

:func:`load_reference_state` installs a snapshot of a JAX ``KeyedStage`` —
plain numpy arrays and ints, so this package never imports the other one —
into a fresh port stage, after which both compute the same intervals. It is
this system's counterpart of carrying a model's weights across.

Snapshot layout (a dict)::

    packs              per task: {"keys", "vals", "sizes", "present",
                       "col_iv"} — the ColumnarPack fields of every key the
                       task holds (the JAX backends' checkpoint packs)
    col_iv             (window+1,) int64 — the device fleet's ring clock
    table_keys,        the assignment's override table as aligned arrays
    table_dests        (-1 keys are empty slots)
    n_dest, hash_seed  the base hash router (Hash32 unless ``hash`` says)
    assignment_version the controller's version counter
    last_stats         {"keys", "cost", "mem", "freq"[, "base_loads"]} or
                       None ("base_loads": a sketch-mode snapshot's frozen
                       tail)
    interval           the stage's interval counter

and, for a stage caught between a rebalance and the next interval, the
in-flight protocol state: ``pending_delta`` (the keys the next interval's
pause window buffers, or None), ``migrated_bytes_pending``,
``plan_time_pending``, plus the accumulated ``output_keys`` /
``output_values`` and ``emitted_sum``. These default to a stage at rest.
A stage whose controller runs ``stats_mode="sketch"`` may also carry
``sketch``, the JAX ``SketchStats.state_dict()`` (plain numpy arrays and
numbers): the count-min planes, the SpaceSaving tracker and the
per-destination totals, which the port's sketch then continues from.

Two optional entries cover the choice routers' split stages:

    hash               ``"hash32"`` (the default) or ``"modhash"``: which
                       base router ``hash_seed`` belongs to
    router             a JAX choice router's live state: ``name`` (``"pkg"``,
                       ``"potc"`` or ``"wchoices"``), ``seed``,
                       ``n_choices``, ``chunk`` and ``loads`` (per worker);
                       for ``"potc"`` also ``n_sources``, ``src_loads``
                       ((n_sources, n_dest)) and ``pos``; for
                       ``"wchoices"`` also ``head`` (the sorted head keys),
                       ``head_threshold`` and ``head_capacity``

A PKG split stage caught mid-stream in the JAX package then routes every
later tuple as it would have there.

:func:`load_reference_params` carries a model's weights across: a nested
dict of numpy arrays (``np.asarray`` of each leaf of a JAX parameter
pytree) becomes the same tree of torch tensors, in one call for any of the
ten archs (whisper's ``encoder`` tree included; float32 leaves, such as
mamba's ``a_log`` and the mLSTM's gates, stay float32).
:func:`load_reference_opt_state` does the same for the JAX package's AdamW
state (``opt_init`` / ``opt_update``), so a run can continue in the port
where it stopped there.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.balancer import (Assignment, Hash32, KeyStats, ModHash,
                            resolve_strategy)
from .streams.backends import DeviceBackend
from .streams.device import resolve_device
from .streams.engine import KeyedStage
from .streams.state import ColumnarPack


def load_reference_state(stage: KeyedStage, snapshot: dict) -> None:
    """Install ``snapshot`` (see the module docstring) into ``stage``, which
    must be fresh (no interval processed), have ``n_dest`` tasks, route with
    the snapshot's base hash router and seed, and, when the snapshot
    carries a ``router``, run that router."""
    if stage._interval or stage.total_state_keys():
        raise ValueError("load_reference_state needs a fresh stage")
    n_dest = int(snapshot["n_dest"])
    packs = snapshot["packs"]
    if n_dest != stage.n_tasks or len(packs) != n_dest:
        raise ValueError(f"snapshot has {n_dest} tasks and {len(packs)} "
                         f"packs; the stage has {stage.n_tasks} tasks")

    ctrl = stage.controller
    router = ctrl.assignment.hash_router
    hash_name = snapshot.get("hash", "hash32")
    hash_cls = {"hash32": Hash32, "modhash": ModHash}.get(hash_name)
    if hash_cls is None:
        raise ValueError(f"unknown hash {hash_name!r}; choose 'hash32' or "
                         "'modhash'")
    if not (type(router) is hash_cls
            and router.seed == int(snapshot["hash_seed"])):
        raise ValueError(f"the stage's router must be {hash_cls.__name__} "
                         "with the snapshot's seed")
    choice = snapshot.get("router")
    if choice is not None:
        if ctrl.strategy.name != choice["name"]:
            raise ValueError(f"the snapshot carries a {choice['name']!r} "
                             f"router; the stage runs "
                             f"{ctrl.strategy.name!r}")
        ctrl.use_algorithm(_choice_router(choice))
        _load_router_state(ctrl.strategy, choice, n_dest)
    sketch = snapshot.get("sketch")
    if sketch is not None:
        if ctrl.sketch is None:
            raise ValueError("the snapshot carries a sketch; the stage's "
                             "controller needs stats_mode='sketch'")
        ctrl.sketch.load_state_dict(sketch)
    tk = np.asarray(snapshot["table_keys"], dtype=np.int64)
    td = np.asarray(snapshot["table_dests"], dtype=np.int64)
    live = tk >= 0
    ctrl.assignment = Assignment(router, dict(zip(tk[live].tolist(),
                                                  td[live].tolist())))
    ctrl.assignment_version = int(snapshot["assignment_version"])
    interval = int(snapshot["interval"])
    ctrl._interval = interval
    stats = snapshot["last_stats"]
    if stats is not None:
        stats = KeyStats(keys=stats["keys"], cost=stats["cost"],
                         mem=stats["mem"], freq=stats["freq"],
                         base_loads=stats.get("base_loads"))
    ctrl.last_stats = stats

    stage._interval = interval
    stage.last_stats = stats
    pending = snapshot.get("pending_delta")
    stage._pending_delta_arr = (None if pending is None
                                else np.asarray(pending, dtype=np.int64))
    stage._migrated_bytes_pending = float(
        snapshot.get("migrated_bytes_pending", 0.0))
    stage._plan_time_pending = float(snapshot.get("plan_time_pending", 0.0))
    stage.outputs = dict(zip(
        np.asarray(snapshot.get("output_keys", []), dtype=np.int64).tolist(),
        np.asarray(snapshot.get("output_values", []), dtype=np.int64).tolist()))
    stage.emitted_sum = float(snapshot.get("emitted_sum", 0.0))

    packs = [ColumnarPack(np.asarray(p["keys"], dtype=np.int64),
                          np.asarray(p["vals"], dtype=np.float64),
                          np.asarray(p["sizes"], dtype=np.float64),
                          np.asarray(p["present"], dtype=bool),
                          np.asarray(p["col_iv"], dtype=np.int64))
             for p in packs]
    if isinstance(stage.backend, DeviceBackend):
        fleet = stage.backend.fleet
        maxk = max((int(p.keys.max()) for p in packs if p.keys.size),
                   default=-1)
        if maxk >= 0:
            fleet.ensure_domain(maxk + 1)
        fleet.col_iv = np.asarray(snapshot["col_iv"], dtype=np.int64).copy()
    for store, pack in zip(stage.stores, packs):
        store.install_batch(pack)


def _choice_router(state: dict):
    """A fresh router configured as the snapshot's ``router`` entry says."""
    kwargs = dict(n_choices=int(state["n_choices"]),
                  chunk=int(state["chunk"]), seed=int(state["seed"]))
    if state["name"] == "potc":
        kwargs["n_sources"] = int(state["n_sources"])
    if state["name"] == "wchoices":
        kwargs["head_threshold"] = float(state["head_threshold"])
        kwargs["head_capacity"] = int(state["head_capacity"])
    return type(resolve_strategy(state["name"]))(**kwargs)


def _load_router_state(router, state: dict, n_dest: int) -> None:
    """Give a bound router the snapshot's live loads (``bind`` zeroed
    them) and, for W-Choices, its head set."""
    loads = np.asarray(state["loads"], dtype=np.float64)
    if loads.shape != (n_dest,):
        raise ValueError(f"router loads have shape {loads.shape}, not "
                         f"({n_dest},)")
    if state["name"] == "potc":
        router._src_loads = np.array(state["src_loads"], dtype=np.float64)
        router._pos = int(state["pos"])
        if not np.array_equal(router.loads, loads):
            raise ValueError("potc: src_loads do not sum to loads")
    else:
        router._loads = loads.copy()
    if state["name"] == "wchoices":
        router._head = np.asarray(state["head"], dtype=np.int64).copy()


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a)      # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy refuses: same bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def load_reference_params(tree, device=None):
    """A nested dict of numpy arrays (a JAX parameter or cache tree taken
    leaf by leaf with ``np.asarray``) as the same tree of torch tensors on
    ``device`` (None = the CUDA card), bit for bit; bfloat16 leaves stay
    bfloat16."""
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        return _tensor(node, dev)

    return convert(tree)


def load_reference_opt_state(tree, device=None) -> dict:
    """The JAX package's optimizer state — ``{"m", "v", "master"}`` trees
    and the ``"step"`` counter, each leaf taken with ``np.asarray`` — as the
    port's ``train.optimizer`` state on ``device`` (None = the CUDA card):
    the same trees of float32 tensors, bit for bit, and ``step`` as a 0-d
    int32 tensor."""
    if set(tree) != {"m", "v", "master", "step"}:
        raise ValueError(f"an optimizer state has m, v, master and step; "
                         f"got {sorted(tree)}")
    state = load_reference_params(
        {k: tree[k] for k in ("m", "v", "master")}, device)
    state["step"] = torch.tensor(int(np.asarray(tree["step"])),
                                 dtype=torch.int32,
                                 device=resolve_device(device))
    return state
