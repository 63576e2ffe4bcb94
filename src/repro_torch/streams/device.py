"""Device-resident dense state ring — the device state backend's fleet.

``KeyedStage(state_backend="device")`` keeps windowed per-key state as
tensors on the stage's device and advances a whole interval in one step:
per-key tuple counts, the window-ring slot fold, eviction and the held
totals all happen on the device; the host only derives the float64 closed
forms (costs, emits, sizes) from the step's integer outputs.

Layout — dense key-indexed ring
-------------------------------
* ``vals``  (window+1, domain+1) int32 — the ring of per-interval slots,
* ``pres``  (window+1, domain+1) int32 0/1 — slot-exists flags (slot
  creation is what ``ColumnarSpec.slot_bytes`` charges),

where ``domain`` is a power-of-two high-water mark over ``max key id + 1``
and row ``domain`` is a padding row that no key reaches. Window totals are
column sums; eviction zeroes expired ring columns. Nothing is sorted, and
the step updates ``vals``/``pres`` in place (no second copy of the ring).

The steps (``_interval_step_add``, ``_interval_step_max``, ``_evict_step``,
``_route_dense``) are plain PyTorch ops. In add mode the per-key histogram
is a host ``np.bincount`` uploaded as one (domain+1,) int32 tensor, as in the
JAX package; max mode needs the raw tuple values, so its counts and its
scatter-max (``scatter_reduce_(..., "amax")``) run on the device. The dense
route calls the routing kernel when the stage's substrate is ``"kernels"``.

Bit-identical by construction: everything the operators' closed forms need
— per-key counts, window and current-slot totals *before* the update — is
integer-valued; the step returns int32 and the host finishes in float64.

Ownership is a function of the key: ``dest == F(key)`` and migration moves
every key whose dest changed, so a held key always lives on the task F maps
it to. The fleet keeps a host ``task`` mirror (int32, -1 = not held) for
``key_location`` and migration bookkeeping; migration never touches device
state. :class:`DeviceTaskView` exposes the
:class:`~repro_torch.streams.state.ColumnarPack` contract
(``extract_batch``/``install_batch``) for ``scale_to``'s reconciliation
sweep.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels.ref import fmix32
from ..kernels.routing_lookup import RoutingTable, route_keys
from .state import ColumnarPack, ColumnarSpec

_INT32_MIN = np.iinfo(np.int32).min


def resolve_device(device) -> torch.device:
    """``None`` means the CUDA card; a CUDA request without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def _to_host(t) -> np.ndarray:
    return t if isinstance(t, np.ndarray) else t.cpu().numpy()


def _evict(vals: torch.Tensor, pres: torch.Tensor, expired) -> None:
    for c in expired:
        vals[int(c)].zero_()
        pres[int(c)].zero_()


def _interval_step_add(vals, pres, counts, col: int, expired):
    """One whole "add"-mode interval against the dense ring, in place.

    ``counts`` is the (D+1,) int32 per-key histogram; ``col`` this interval's
    ring column; ``expired`` the columns this boundary evicts. Returns the
    window/slot totals BEFORE the update, then per-key held slot-count and
    value-sum AFTER eviction, each (D+1,) int32.
    """
    win0 = vals.sum(dim=0, dtype=torch.int32)
    slot0 = vals[col].clone()
    vals[col] += counts
    pres[col] = torch.maximum(pres[col], (counts > 0).to(torch.int32))
    _evict(vals, pres, expired)
    return (win0, slot0, pres.sum(dim=0, dtype=torch.int32),
            vals.sum(dim=0, dtype=torch.int32))


def _interval_step_max(vals, pres, keys, tvals, dest_dense, col: int,
                       expired, n_tasks: int):
    """One whole "max"-mode interval: scatter-max fold over the raw tuples.

    ``keys`` (N,) int64 and ``tvals`` (N,) int32 on the device;
    ``dest_dense`` (D+1,) int32 F(k) for every key id. Returns per-key
    counts, window/slot totals BEFORE the update, held slot-count and
    value-sum AFTER eviction, and the per-task tuple counts.
    """
    d1 = vals.shape[1]
    counts = torch.bincount(keys, minlength=d1).to(torch.int32)
    win0 = vals.sum(dim=0, dtype=torch.int32)
    slot0 = vals[col].clone()
    seen = counts > 0
    gmax = torch.full((d1,), _INT32_MIN, dtype=torch.int32, device=vals.device)
    gmax.scatter_reduce_(0, keys, tvals, "amax")
    vals[col] = torch.where(seen, torch.maximum(slot0, gmax), slot0)
    pres[col] = torch.maximum(pres[col], seen.to(torch.int32))
    _evict(vals, pres, expired)
    task_counts = torch.zeros(n_tasks, dtype=torch.int64, device=vals.device)
    task_counts.index_add_(0, dest_dense.to(torch.int64),
                           counts.to(torch.int64))
    return (counts, win0, slot0, pres.sum(dim=0, dtype=torch.int32),
            vals.sum(dim=0, dtype=torch.int32), task_counts)


def _evict_step(vals, pres, expired):
    """Boundary eviction for a tuple-free interval (no slot updates)."""
    _evict(vals, pres, expired)
    return pres.sum(dim=0, dtype=torch.int32), vals.sum(dim=0,
                                                         dtype=torch.int32)


def _route_dense(all_keys, tkeys, tdests, n_dest: int, seed: int):
    """F(k) for every key id at once: fmix32 hash + table-override scatter.
    Empty table slots (-1) scatter onto the padding row, whose dest is never
    read."""
    base = (fmix32(all_keys, seed) % n_dest).to(torch.int32)
    d1 = all_keys.shape[0]
    ok = (tkeys >= 0) & (tkeys < d1)
    slot = torch.where(ok, tkeys, d1 - 1).to(torch.int64)
    return base.index_put_((slot,), torch.where(ok, tdests, base[d1 - 1]))


class DeviceStateFleet:
    """Shared device state ring + host mirrors for one stage's task fleet.

    One fleet serves ALL task instances of a stage (state is key-indexed;
    task ownership is the host ``task`` label array), so per-interval work
    is one step regardless of the task count.
    """

    def __init__(self, window: int, spec: ColumnarSpec, device,
                 min_domain: int = 512):
        if spec.mode not in ("add", "max"):
            raise ValueError(f"unknown columnar mode {spec.mode!r}")
        self.device = resolve_device(device)
        self.window = window
        self.spec = spec
        self._ncols = window + 1
        self._min_domain = min_domain
        self.domain = 0                    # valid key ids are [0, domain)
        self.col_iv = np.full(self._ncols, -1, dtype=np.int64)
        self.task = np.full(1, -1, dtype=np.int32)       # (domain+1,)
        self.mem = np.zeros(1, dtype=np.float64)         # S(k, w) mirror
        self.vals = torch.zeros((self._ncols, 1), dtype=torch.int32,
                                device=self.device)
        self.pres = torch.zeros_like(self.vals)
        self._all_keys: Optional[torch.Tensor] = None    # arange(domain+1)
        self._host_vals: Optional[np.ndarray] = None
        self._host_pres: Optional[np.ndarray] = None
        self._host_dirty = True

    # -- shape management -------------------------------------------------------
    def ensure_domain(self, needed: int) -> bool:
        """Grow the dense domain to a power-of-two >= ``needed``, copying live
        state forward. Returns True on growth."""
        if needed <= self.domain:
            return False
        dom = max(self._min_domain, 1 << (int(needed) - 1).bit_length())
        d1 = dom + 1
        vals = torch.zeros((self._ncols, d1), dtype=torch.int32,
                           device=self.device)
        pres = torch.zeros_like(vals)
        task = np.full(d1, -1, dtype=np.int32)
        mem = np.zeros(d1, dtype=np.float64)
        if self.domain:
            # the old padding row is all-zero by construction; copy real rows
            vals[:, :self.domain] = self.vals[:, :self.domain]
            pres[:, :self.domain] = self.pres[:, :self.domain]
            task[:self.domain] = self.task[:self.domain]
            mem[:self.domain] = self.mem[:self.domain]
        self.domain = dom
        self.vals, self.pres = vals, pres
        self.task, self.mem = task, mem
        self._all_keys = None
        self._host_dirty = True
        return True

    # -- the interval step ------------------------------------------------------
    def interval_step(self, keys: np.ndarray, tuple_vals: Optional[np.ndarray],
                      dest_dense, n_tasks: int, keep_cols: np.ndarray,
                      col: int, mode: str):
        """Run one interval's step.

        Returns ``(counts, win0, slot0, held_cnt, held_sum, task_counts)``
        as (domain+1,)-shaped tensors (``task_counts`` (n_tasks,));
        ``counts`` is a host int32 array in add mode (the histogram is
        computed host-side) and ``task_counts`` is None there.
        """
        expired = np.flatnonzero(keep_cols == 0)
        self._host_dirty = True
        if mode == "add":
            counts = np.bincount(keys, minlength=self.domain + 1) \
                .astype(np.int32)
            out = _interval_step_add(
                self.vals, self.pres,
                torch.from_numpy(counts).to(self.device), col, expired)
            return (counts,) + out + (None,)
        return _interval_step_max(
            self.vals, self.pres, torch.from_numpy(keys).to(self.device),
            torch.from_numpy(tuple_vals.astype(np.int32)).to(self.device),
            dest_dense, col, expired, n_tasks)

    def evict(self, keep_cols: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        held_cnt, held_sum = _evict_step(self.vals, self.pres,
                                         np.flatnonzero(keep_cols == 0))
        self._host_dirty = True
        return held_cnt.cpu().numpy(), held_sum.cpu().numpy()

    def route_dense(self, tkeys: np.ndarray, tdests: np.ndarray, n_dest: int,
                    seed: int, use_kernel: bool) -> torch.Tensor:
        """Dense dest table over arange(domain + 1): the routing kernel or
        the plain scatter."""
        d1 = self.domain + 1
        if self._all_keys is None or int(self._all_keys.shape[0]) != d1:
            self._all_keys = torch.arange(d1, dtype=torch.int32,
                                          device=self.device)
        if use_kernel:
            table = RoutingTable.from_arrays(tkeys, tdests, self.device)
            return route_keys(self._all_keys, table, n_dest, seed=seed)
        tk = torch.from_numpy(tkeys.astype(np.int32)).to(self.device)
        td = torch.from_numpy(tdests.astype(np.int32)).to(self.device)
        return _route_dense(self._all_keys, tk, td, n_dest, seed)

    def dest_host_dense(self, dev: torch.Tensor) -> np.ndarray:
        """Host copy of a ``route_dense`` table: ``(domain+1,)`` int64 with
        ``out[k] == F(k)``."""
        return dev.cpu().numpy().astype(np.int64)

    # -- host snapshots (pack contract + introspection) -------------------------
    def host_state(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._host_dirty:
            self._host_vals = self.vals.cpu().numpy()
            self._host_pres = self.pres.cpu().numpy()
            self._host_dirty = False
        return self._host_vals, self._host_pres

    def sizes_matrix(self, rows: np.ndarray) -> np.ndarray:
        """(M, W1) float64 per-column sizes — the ColumnarPack closed form:
        slot creation charges ``slot_bytes``; each folded unit charges
        ``bytes_per_unit``."""
        host_vals, host_pres = self.host_state()
        pres = host_pres[:, rows].T.astype(np.float64)
        vals = host_vals[:, rows].T.astype(np.float64)
        return self.spec.slot_bytes * pres + self.spec.bytes_per_unit * vals

    def clear_rows(self, rows: np.ndarray) -> None:
        idx = torch.from_numpy(rows.astype(np.int64)).to(self.device)
        self.vals[:, idx] = 0
        self.pres[:, idx] = 0
        self.task[rows] = -1
        self.mem[rows] = 0.0
        self._host_dirty = True

    def install_rows(self, rows: np.ndarray, vals_cols: np.ndarray,
                     pres_cols: np.ndarray, task_idx: int,
                     sizes_rows: np.ndarray) -> None:
        idx = torch.from_numpy(rows.astype(np.int64)).to(self.device)
        self.vals[:, idx] = torch.from_numpy(
            np.ascontiguousarray(vals_cols.T.astype(np.int32))).to(self.device)
        self.pres[:, idx] = torch.from_numpy(
            np.ascontiguousarray(pres_cols.T.astype(np.int32))).to(self.device)
        self.task[rows] = task_idx
        self.mem[rows] = sizes_rows.sum(axis=1)
        self._host_dirty = True


class _DeviceKeysView:
    """Dict-like ``store.keys`` surface over one task's ownership labels."""

    def __init__(self, fleet: DeviceStateFleet, index: int):
        self._fleet = fleet
        self._index = index

    def _mask(self) -> np.ndarray:
        return self._fleet.task[:self._fleet.domain] == self._index

    def __len__(self) -> int:
        return int(self._mask().sum())

    def __iter__(self):
        return iter(np.nonzero(self._mask())[0].tolist())

    def __contains__(self, key) -> bool:
        k = int(key)
        return (0 <= k < self._fleet.domain
                and int(self._fleet.task[k]) == self._index)


class DeviceTaskView:
    """One task instance's window onto the shared device fleet: ``keys``
    membership (``key_location``), ``sizes_arrays`` and the
    ``extract_batch``/``install_batch`` ColumnarPack contract."""

    def __init__(self, fleet: DeviceStateFleet, index: int):
        self.fleet = fleet
        self.index = index

    @property
    def keys(self) -> _DeviceKeysView:
        return _DeviceKeysView(self.fleet, self.index)

    def sizes_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        fleet = self.fleet
        held = np.nonzero(fleet.task[:fleet.domain] == self.index)[0]
        return held.astype(np.int64), fleet.mem[held]

    def extract_batch(self, keys: np.ndarray) -> ColumnarPack:
        fleet = self.fleet
        arr = np.unique(np.asarray(keys, dtype=np.int64).ravel())
        arr = arr[(arr >= 0) & (arr < fleet.domain)]
        rows = arr[fleet.task[arr] == self.index]
        host_vals, host_pres = fleet.host_state()
        pack = ColumnarPack(rows,
                            host_vals[:, rows].T.astype(np.float64),
                            fleet.sizes_matrix(rows),
                            host_pres[:, rows].T.astype(bool),
                            fleet.col_iv.copy())
        if rows.size:
            fleet.clear_rows(rows)
        return pack

    def install_batch(self, pack: ColumnarPack) -> None:
        fleet = self.fleet
        if not pack.keys.size:
            return
        taken = pack.keys[fleet.task[pack.keys] >= 0]
        if taken.size:
            raise RuntimeError(
                f"key {int(taken[0])} already present on target task")
        live = pack.col_iv >= 0
        conflict = live & (fleet.col_iv >= 0) & (fleet.col_iv != pack.col_iv)
        if conflict.any():
            raise RuntimeError(
                "columnar install across skewed interval clocks: source and "
                "target stores disagree on column contents")
        fleet.col_iv = np.where(live & (fleet.col_iv < 0), pack.col_iv,
                                fleet.col_iv)
        fleet.install_rows(pack.keys, pack.vals, pack.present, self.index,
                           pack.sizes)
