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
    n_dest, hash_seed  the Hash32 router
    assignment_version the controller's version counter
    last_stats         {"keys", "cost", "mem", "freq"} or None
    interval           the stage's interval counter

and, for a stage caught between a rebalance and the next interval, the
in-flight protocol state: ``pending_delta`` (the keys the next interval's
pause window buffers, or None), ``migrated_bytes_pending``,
``plan_time_pending``, plus the accumulated ``output_keys`` /
``output_values`` and ``emitted_sum``. These default to a stage at rest.

:func:`load_reference_params` carries a model's weights across: a nested
dict of numpy arrays (``np.asarray`` of each leaf of a JAX parameter
pytree) becomes the same tree of torch tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.balancer import Assignment, Hash32, KeyStats
from .streams.backends import DeviceBackend
from .streams.device import resolve_device
from .streams.engine import KeyedStage
from .streams.state import ColumnarPack


def load_reference_state(stage: KeyedStage, snapshot: dict) -> None:
    """Install ``snapshot`` (see the module docstring) into ``stage``, which
    must be fresh (no interval processed), have ``n_dest`` tasks and route
    with ``Hash32(n_dest, hash_seed)``."""
    if stage._interval or stage.total_state_keys():
        raise ValueError("load_reference_state needs a fresh stage")
    n_dest = int(snapshot["n_dest"])
    packs = snapshot["packs"]
    if n_dest != stage.n_tasks or len(packs) != n_dest:
        raise ValueError(f"snapshot has {n_dest} tasks and {len(packs)} "
                         f"packs; the stage has {stage.n_tasks} tasks")

    ctrl = stage.controller
    router = ctrl.assignment.hash_router
    if not (isinstance(router, Hash32)
            and router.seed == int(snapshot["hash_seed"])):
        raise ValueError("the stage's router must be Hash32 with the "
                         "snapshot's seed")
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
                         mem=stats["mem"], freq=stats["freq"])
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
