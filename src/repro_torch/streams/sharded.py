"""The dense device ring sharded over a ``torch.distributed`` process group —
the JAX package's ``streams/sharded.py``.

``KeyedStage(state_backend="sharded")`` splits :mod:`.device`'s dense
key-indexed ring across the ranks of the default process group, one rank
per device, with one collective exchange per interval.

SPMD over ranks
---------------
The JAX package runs one controller that drives a ``shard_map`` over a
mesh. The port runs the same program on every rank instead, PyTorch's
idiom: each rank builds the same :class:`~.engine.KeyedStage`, feeds it the
same interval input and so runs the same host logic (the controller and
its plans, the float64 closed forms, the ownership and ``mem`` mirrors) in
lockstep. Only the ring is sharded, so each rank makes the same
collective calls in the same order.

The caller owns the process group: a launcher, ``torchrun``, spawned test
ranks. ``n_shards=None`` means the group's size, and any other value, or
no group at all, raises ``ValueError``. The JAX package can run on a
sub-mesh of its devices (``n_shards`` below the device count); here a
shard count is a group size, so a caller that wants another shard count
makes another group. NCCL goes with CUDA tensors and gloo with CPU
tensors; any other pairing raises. Nothing falls back to a local copy
when a collective fails.

Placement: key-block sharding
-----------------------------
The global dense domain ``D`` (a power-of-two high-water mark, as on one
device) is split into ``S`` contiguous blocks of ``B = ceil(D / S)`` keys;
key ``k`` lives on rank ``k // B`` at local row ``k % B`` forever, and
each rank keeps a local sink row ``B`` that no key reaches. A rank holds
``(window+1, B+1)`` int32 ``vals`` and ``pres``. Placement is a function of
the key, not of the assignment: F(k) moves keys between *tasks*, never
between ranks, so migration stays relabel-only (the host ``task`` mirror).

Dataflow
--------
Each rank takes its positional chunk of the interval's keys (padded with
-1 to a power-of-two ``cap``, as the JAX package pads its chunks):

* "add" mode: the rank builds the ``(S, B+1)`` partial histogram of its
  chunk on its device (row = destination rank), one
  ``all_to_all_single`` transposes the partials, and the rank sums its
  ``S`` rows and folds them into its block;
* "max" mode: the rank builds masked ``(S, cap)`` send matrices of keys and
  values (-1 and ``INT32_MIN`` in lanes bound for other ranks), stacked
  into one buffer, so the same single ``all_to_all_single`` delivers every
  tuple to its owner, which counts and scatter-maxes locally.

The step's per-key outputs (counts, window and slot totals before the
update, held slot-count and value-sum after eviction) come back to every
rank through one ``all_gather_into_tensor`` and are de-interleaved into the
key-dense ``(D+1,)`` views that :class:`~.backends.DeviceBackend`'s host
code reads, so it cannot tell the two fleets apart.

The routing table stays replicated (the paper's small table): on a new
``assignment_version`` each rank computes F(k) for its own ids
``rank * B + arange(B+1)`` only, through the routing kernel on the
``"kernels"`` substrate on a CUDA device (the JAX package uses its jnp
twin there), or the plain scatter. The sink row keeps the plain hash of
its id, as in the JAX package: the kernel would route id ``(rank+1) * B``
through the table, so the row is reset after the kernel runs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.ref import fmix32
from ..kernels.routing_lookup import RoutingTable, route_keys
from .backends import DeviceBackend, register_backend
from .device import (DeviceStateFleet, _evict_step, _interval_step_add,
                     _route_dense)
from .state import ColumnarSpec

_INT32_MIN = np.iinfo(np.int32).min

#: the tensor device each process-group backend exchanges
_GROUP_DEVICE = {"nccl": "cuda", "gloo": "cpu"}


def _group_size(n_shards: Optional[int], device: torch.device) -> int:
    """The default group's size, after checking it against ``n_shards`` and
    the group's backend against ``device``."""
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            f"state_backend='sharded' needs an initialised torch.distributed "
            f"process group (n_shards={n_shards}, group size: none): the "
            "caller starts one rank per shard and calls "
            "init_process_group first")
    world = dist.get_world_size()
    if n_shards is not None and int(n_shards) != world:
        raise ValueError(
            f"n_shards={n_shards} differs from the process group's size "
            f"{world}: a sharded stage uses every rank of the default group "
            "(make a group of n_shards ranks instead)")
    backend = str(dist.get_backend())
    if _GROUP_DEVICE.get(backend) != device.type:
        raise ValueError(
            f"a {backend!r} process group cannot exchange {device.type} "
            "tensors: NCCL goes with CUDA devices and gloo with the CPU")
    return world


class ShardedStateFleet(DeviceStateFleet):
    """The dense state ring, one key block per rank of the default group.

    The surface of :class:`~.device.DeviceStateFleet`, but ``vals`` and
    ``pres`` are this rank's ``(window+1, B+1)`` block, and every
    host-facing output (step observables, the route table's host copy,
    ``host_state``) is the key-dense ``(D+1,)`` layout, gathered from every
    rank. Every method that gathers is a collective: the ranks call them in
    the same order because they run the same host logic.
    """

    def __init__(self, window: int, spec: ColumnarSpec, device,
                 n_shards: Optional[int] = None, min_domain: int = 512):
        super().__init__(window, spec, device, min_domain)
        self.n_shards = _group_size(n_shards, self.device)
        self.rank = dist.get_rank()
        self._block = 0            # B: keys per rank; the local sink row is B
        self._chunk_cap = 0        # per-rank tuple-chunk pad (pow2 HWM)

    # -- layout helpers ---------------------------------------------------------
    def _local(self, rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Which of ``rows`` (global key ids) this rank holds, and their
        local rows."""
        mine = np.flatnonzero(rows // self._block == self.rank)
        return mine, (rows[mine] % self._block).astype(np.int64)

    def _gather(self, local: torch.Tensor) -> np.ndarray:
        """``(..., B+1)`` blocks of every rank -> host ``(S, ..., B+1)``."""
        out = torch.empty(self.n_shards * local.numel(), dtype=local.dtype,
                          device=local.device)
        dist.all_gather_into_tensor(out, local.reshape(-1))
        return out.cpu().numpy().reshape((self.n_shards,)
                                         + tuple(local.shape))

    def _to_dense(self, blocks: np.ndarray) -> np.ndarray:
        """Host ``(S, ..., B+1)`` -> key-dense ``(..., domain+1)``: the blocks
        side by side without their sink rows, the dead ids past the domain
        dropped, the padding row 0."""
        lead = blocks.shape[1:-1]
        out = np.zeros(lead + (self.domain + 1,), blocks.dtype)
        if self._block:                    # else the domain never grew
            out[..., :self.domain] = np.moveaxis(
                blocks[..., :self._block], 0, -2).reshape(
                    lead + (-1,))[..., :self.domain]
        return out

    # -- shape management -------------------------------------------------------
    def ensure_domain(self, needed: int) -> bool:
        if needed <= self.domain:
            return False
        old_dom = self.domain
        if old_dom:
            old_vals, old_pres = self.host_state()    # key-dense (W1, D+1)
        dom = max(self._min_domain, 1 << (int(needed) - 1).bit_length())
        S = self.n_shards
        B = -(-dom // S)          # ceil: ids in [dom, S*B) are dead padding
        vals = torch.zeros((self._ncols, B + 1), dtype=torch.int32,
                           device=self.device)
        pres = torch.zeros_like(vals)
        task = np.full(dom + 1, -1, dtype=np.int32)
        mem = np.zeros(dom + 1, dtype=np.float64)
        self._block = B
        if old_dom:
            lo = self.rank * B
            hi = min(lo + B, old_dom)
            if hi > lo:
                vals[:, :hi - lo] = torch.from_numpy(
                    np.ascontiguousarray(old_vals[:, lo:hi]))
                pres[:, :hi - lo] = torch.from_numpy(
                    np.ascontiguousarray(old_pres[:, lo:hi]))
            task[:old_dom] = self.task[:old_dom]
            mem[:old_dom] = self.mem[:old_dom]
        self.domain = dom
        self.vals, self.pres = vals, pres
        self.task, self.mem = task, mem
        self._host_dirty = True
        return True

    # -- the interval step ------------------------------------------------------
    def _chunk(self, arr: np.ndarray, n: int, pad: int) -> torch.Tensor:
        """This rank's positional chunk of ``arr[:n]``, padded to ``cap``."""
        cap = self._chunk_cap
        out = np.full(cap, pad, dtype=np.int32)
        part = arr[self.rank * cap:min(n, (self.rank + 1) * cap)]
        out[:part.size] = part
        return torch.from_numpy(out).to(self.device)

    def interval_step(self, keys: np.ndarray, tuple_vals: Optional[np.ndarray],
                      dest_dense, n_tasks: int, keep_cols: np.ndarray,
                      col: int, mode: str):
        """The parent's contract with host key-dense outputs; ``task_counts``
        is always None (the backend derives per-task loads from the counts
        and its host dest mirror, as the JAX package's does)."""
        S, B = self.n_shards, self._block
        L = B + 1
        n = int(keys.shape[0])
        per = -(-n // S) if n else 1
        if per > self._chunk_cap:
            self._chunk_cap = max(256, 1 << (per - 1).bit_length())
        k = self._chunk(keys, n, -1)
        valid = k >= 0
        expired = np.flatnonzero(keep_cols == 0)
        self._host_dirty = True
        if mode == "add":
            # partial histogram, row = owning rank; padded lanes land in an
            # extra bin that is dropped
            idx = torch.where(valid, (k // B) * L + k % B, S * L)
            partial = torch.bincount(idx.to(torch.int64),
                                     minlength=S * L + 1)[:S * L] \
                .to(torch.int32).reshape(S, L)
            recv = torch.empty_like(partial)
            dist.all_to_all_single(recv, partial)
            counts = recv.sum(dim=0, dtype=torch.int32)
            counts[B] = 0
            win0, slot0, held_cnt, held_sum = _interval_step_add(
                self.vals, self.pres, counts, col, expired)
        else:
            v = self._chunk(tuple_vals, n, _INT32_MIN)
            owner = torch.where(valid, k // B, -1)
            hit = owner[None, :] == torch.arange(S, device=k.device)[:, None]
            send = torch.stack([torch.where(hit, k[None, :], -1),
                                torch.where(hit, v[None, :], _INT32_MIN)], 1)
            recv = torch.empty_like(send)                 # (S, 2, cap)
            dist.all_to_all_single(recv, send)
            rk, rv = recv[:, 0].reshape(-1), recv[:, 1].reshape(-1)
            r = torch.where(rk >= 0, rk % B, B).to(torch.int64)
            counts = torch.bincount(r, minlength=L).to(torch.int32)
            counts[B] = 0
            gmax = torch.full((L,), _INT32_MIN, dtype=torch.int32,
                              device=self.device)
            gmax.scatter_reduce_(0, r, rv, "amax")
            win0 = self.vals.sum(dim=0, dtype=torch.int32)
            slot0 = self.vals[col].clone()
            seen = counts > 0
            self.vals[col] = torch.where(seen, torch.maximum(slot0, gmax),
                                         slot0)
            self.pres[col] = torch.maximum(self.pres[col],
                                           seen.to(torch.int32))
            held_cnt, held_sum = _evict_step(self.vals, self.pres, expired)
        out = self._to_dense(self._gather(torch.stack(
            [counts, win0, slot0, held_cnt, held_sum])))
        return tuple(out) + (None,)

    def evict(self, keep_cols: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        held = _evict_step(self.vals, self.pres,
                           np.flatnonzero(keep_cols == 0))
        self._host_dirty = True
        cnt, tot = self._to_dense(self._gather(torch.stack(held)))
        return cnt, tot

    def route_dense(self, tkeys: np.ndarray, tdests: np.ndarray, n_dest: int,
                    seed: int, use_kernel: bool) -> torch.Tensor:
        """F(k) for this rank's ids ``rank*B + arange(B+1)`` from the
        replicated table: the routing kernel (the plain version on a CPU
        device) or the plain scatter. Returns this rank's (B+1,) int32."""
        B = self._block
        kid = self.rank * B + torch.arange(B + 1, dtype=torch.int32,
                                           device=self.device)
        if use_kernel:
            table = RoutingTable.from_arrays(tkeys, tdests, self.device)
            out = route_keys(kid, table, n_dest, seed=seed)
            # the sink row keeps its id's plain hash (the kernel would route
            # id (rank+1)*B through the table, which another rank owns)
            out[B:] = (fmix32(kid[B:], seed) % n_dest).to(torch.int32)
            return out
        tk = tkeys.astype(np.int64)
        mine = (tk >= 0) & (tk < self.n_shards * B) & (tk // B == self.rank)
        local = np.where(mine, tk - self.rank * B, -1).astype(np.int32)
        return _route_dense(
            kid, torch.from_numpy(local).to(self.device),
            torch.from_numpy(tdests.astype(np.int32)).to(self.device),
            n_dest, seed)

    def dest_host_dense(self, dev: torch.Tensor) -> np.ndarray:
        return self._to_dense(self._gather(dev)).astype(np.int64)

    # -- host snapshots (pack contract + introspection) -------------------------
    def host_state(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._host_dirty:
            both = self._to_dense(self._gather(torch.stack([self.vals,
                                                            self.pres])))
            self._host_vals, self._host_pres = both[0], both[1]
            self._host_dirty = False
        return self._host_vals, self._host_pres

    # the host snapshot is a gather from every rank, so the row edits of
    # scale_to and restore are applied to it as well instead of marking it
    # stale (a checkpoint then gathers once, not once per task)
    def clear_rows(self, rows: np.ndarray) -> None:
        _, local = self._local(rows)
        idx = torch.from_numpy(local).to(self.device)
        self.vals[:, idx] = 0
        self.pres[:, idx] = 0
        if not self._host_dirty:
            self._host_vals[:, rows] = 0
            self._host_pres[:, rows] = 0
        self.task[rows] = -1
        self.mem[rows] = 0.0

    def install_rows(self, rows: np.ndarray, vals_cols: np.ndarray,
                     pres_cols: np.ndarray, task_idx: int,
                     sizes_rows: np.ndarray) -> None:
        mine, local = self._local(rows)
        vals = vals_cols.T.astype(np.int32)
        pres = pres_cols.T.astype(np.int32)
        idx = torch.from_numpy(local).to(self.device)
        self.vals[:, idx] = torch.from_numpy(
            np.ascontiguousarray(vals[:, mine])).to(self.device)
        self.pres[:, idx] = torch.from_numpy(
            np.ascontiguousarray(pres[:, mine])).to(self.device)
        if not self._host_dirty:
            self._host_vals[:, rows] = vals
            self._host_pres[:, rows] = pres
        self.task[rows] = task_idx
        self.mem[rows] = sizes_rows.sum(axis=1)


@register_backend
class ShardedDeviceBackend(DeviceBackend):
    """The device backend over a :class:`ShardedStateFleet`.

    Everything above the fleet (closed forms, mirrors, stats, emits,
    relabel-only migration, checkpoint and restore) is
    :class:`~.backends.DeviceBackend`'s. Explicit-only: ``auto`` never
    picks it, since the shard count is the launcher's choice.
    """

    name = "sharded"

    def _make_fleet(self) -> ShardedStateFleet:
        stage = self.stage
        return ShardedStateFleet(stage.window, stage.operator.columnar_spec,
                                 stage.device, n_shards=stage.n_shards)

    @classmethod
    def auto_eligible(cls, operator, controller, vectorized, device):
        return False
