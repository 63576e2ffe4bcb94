"""F(k) routing (paper Eq. 1) on the card — the hand-written CUDA kernel and
its wrapper.

Port of the JAX package's Pallas ``_routing_kernel``
(``repro/kernels/routing_lookup.py``). The kernel is
``csrc/routing_lookup.cu``; this module checks the inputs, allocates the
output, launches it on PyTorch's current stream and counts the launch. A
tensor on the CPU takes the plain PyTorch version instead
(:func:`route_plain`); a CUDA tensor always launches the kernel.

The override table travels as a :class:`RoutingTable`: a sorted,
duplicate-free copy built once per assignment version, so each launch only
binary-searches it. Duplicate non-empty table keys are refused with
``ValueError``: the JAX package's two versions disagree on them (the Pallas
kernel returns the largest dest, its ``ref.routing_lookup`` the first slot),
and ``Assignment.table_arrays`` never produces any.

Keys are tuple ids in ``[0, 2**31)``. As in the JAX package's
``ref.routing_lookup``, a key equal to a table key takes the dest of the
first such slot, and key -1 is no exception: it matches an empty slot
(key -1, dest 0) and takes that slot's dest. The table is sorted stably,
so among the empty slots the lower-bound search finds the one that came
first. A key below -1 matches no slot and routes by its hash.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import numpy as np
import torch

from . import _build
from .ref import fmix32

_BLOCK = 256
#: blocks per SM: each block stages the whole table in shared memory, so a
#: grid-stride loop over a few resident blocks per SM loads it fewest times
_BLOCKS_PER_SM = 4
#: largest table the kernel stages in shared memory (8 bytes a slot; Hopper
#: gives a block at most 227 KB)
MAX_TABLE = 16384
_SM_COUNT: Dict[int, int] = {}


def require_int32(kernel: str, name: str, t: torch.Tensor) -> None:
    """Int32 contract: the kernels' integer lanes are 32-bit, so a wider (or
    float) key array would alias ids >= 2**31 instead of failing."""
    if t.dtype != torch.int32:
        raise TypeError(
            f"{kernel} requires int32 {name} (got {t.dtype}): the kernel "
            "operates on 32-bit integer lanes, so wider ids would silently "
            "alias after truncation — validate ids are in [0, 2**31) and "
            "cast explicitly")


def sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(idx) \
            .multi_processor_count
    return _SM_COUNT[idx]


class RoutingTable:
    """The override table A of F, sorted by key, on one device.

    Built from ``(table_keys, table_dests)`` int32 tensors of one shape
    (-1 = empty slot). Raises ``ValueError`` on duplicate non-empty keys.
    """

    def __init__(self, table_keys: torch.Tensor, table_dests: torch.Tensor):
        require_int32("routing_lookup", "table_keys", table_keys)
        require_int32("routing_lookup", "table_dests", table_dests)
        if table_keys.dim() != 1 or table_keys.shape != table_dests.shape:
            raise ValueError("table_keys and table_dests must be 1-D tensors "
                             "of one shape")
        if table_keys.device != table_dests.device:
            raise ValueError("table_keys and table_dests must share a device")
        if table_keys.numel() > MAX_TABLE:
            raise ValueError(f"routing table of {table_keys.numel()} slots "
                             f"exceeds MAX_TABLE={MAX_TABLE}")
        keys, order = torch.sort(table_keys, stable=True)
        dup = (keys[1:] == keys[:-1]) & (keys[1:] >= 0)
        if bool(dup.any()):
            k = int(keys[1:][dup][0])
            raise ValueError(
                f"duplicate routing table key {k}: F(k) needs one dest per "
                "key (the reference kernels disagree on duplicates)")
        self.keys = keys.contiguous()
        self.dests = table_dests[order].contiguous()

    @classmethod
    def from_arrays(cls, table_keys: np.ndarray, table_dests: np.ndarray,
                    device) -> "RoutingTable":
        """From ``Assignment.table_arrays`` output (ids must fit int32)."""
        return cls(torch.from_numpy(table_keys.astype(np.int32)).to(device),
                   torch.from_numpy(table_dests.astype(np.int32)).to(device))

    @property
    def device(self) -> torch.device:
        return self.keys.device

    def __len__(self) -> int:
        return int(self.keys.numel())


def route_plain(keys: torch.Tensor, table: RoutingTable, n_dest: int,
                seed: int = 0) -> torch.Tensor:
    """Plain PyTorch F(k): hash, then a binary search of the sorted table."""
    base = (fmix32(keys, seed) % n_dest).to(torch.int32)
    a = len(table)
    if a == 0:
        return base
    pos = torch.searchsorted(table.keys, keys).clamp_(max=a - 1)
    hit = table.keys[pos] == keys
    return torch.where(hit, table.dests[pos], base)


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = _build.load("routing_lookup")
    fn = lib.routing_lookup_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def route_keys(keys: torch.Tensor, table: RoutingTable, n_dest: int,
               seed: int = 0) -> torch.Tensor:
    """F(k) for a 1-D int32 key tensor: the CUDA kernel for a CUDA tensor,
    :func:`route_plain` for a CPU tensor. Returns int32 dests."""
    require_int32("routing_lookup", "keys", keys)
    if keys.dim() != 1:
        raise ValueError("keys must be a 1-D tensor")
    if keys.device != table.device:
        raise ValueError(f"keys on {keys.device} but routing table on "
                         f"{table.device}")
    if not 0 < n_dest < 2**31:
        raise ValueError(f"n_dest must be in [1, 2**31), got {n_dest}")
    if keys.device.type == "cpu":
        return route_plain(keys, table, n_dest, seed)
    if keys.device.type != "cuda":
        raise ValueError(f"routing_lookup runs on cuda or cpu tensors, not "
                         f"{keys.device.type}")
    keys = keys.contiguous()
    out = torch.empty_like(keys)
    n = keys.numel()
    if n == 0:
        return out
    grid = min(-(-n // _BLOCK), _BLOCKS_PER_SM * sm_count(keys.device))
    err = _launcher()(keys.data_ptr(), n, table.keys.data_ptr(),
                      table.dests.data_ptr(), len(table), n_dest,
                      seed & 0xFFFFFFFF, out.data_ptr(), grid, _BLOCK,
                      torch.cuda.current_stream(keys.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"routing_lookup kernel launch failed: CUDA "
                           f"error {err}")
    route_keys.launches += 1
    return out


#: kernel launches since the count was last set to 0
route_keys.launches = 0


def routing_lookup(keys: torch.Tensor, table_keys: torch.Tensor,
                   table_dests: torch.Tensor, n_dest: int,
                   seed: int = 0) -> torch.Tensor:
    """F(k) against a raw ``(table_keys, table_dests)`` table (-1 = empty
    slot): builds the :class:`RoutingTable` and routes. Callers that route
    many batches against one table build the table once and call
    :func:`route_keys`."""
    return route_keys(keys, RoutingTable(table_keys, table_dests), n_dest,
                      seed)
