"""F(k) routing (paper Eq. 1) on the card — the hand-written CUDA kernel and
its wrapper.

Port of the JAX package's Pallas ``_routing_kernel``
(``repro/kernels/routing_lookup.py``). The kernel is
``csrc/routing_lookup.cu``; this module builds its table, checks the inputs,
allocates the output, launches it on PyTorch's current stream and counts the
launch. A tensor on the CPU takes the plain PyTorch version instead
(:func:`route_plain`); a CUDA tensor always launches the kernel.

The override table travels as a :class:`RoutingTable`, built once per
assignment version on the host in numpy (:meth:`RoutingTable.build`: no
device sort, no host sync) and uploaded in one copy (:meth:`RoutingTable.to`).
It is an open-addressing hash table of ``{key, dest}`` pairs in buckets of
two slots, which the kernel probes; ``csrc/routing_lookup.cu`` describes the
layout. Duplicate non-negative table keys are refused with ``ValueError``:
the JAX package's two versions disagree on them (the Pallas kernel returns
the largest dest, its ``ref.routing_lookup`` the first slot), and
``Assignment.table_arrays`` never produces any. Dests must be >= 0: the
table marks its empty slots by a dest of -1.

Keys are tuple ids in ``[0, 2**31)``. As in the JAX package's
``ref.routing_lookup``, a key equal to a table key takes the dest of the
first such slot, and key -1 is no exception: it matches an empty slot
(key -1, dest 0) and takes the first one's dest. A key below -1 matches no
slot and routes by its hash.

The JAX package's ``core/routing.py`` (its jnp data plane, which only its
tests import) is not copied; this module computes the same function:

* ``hash_route(keys, n_dest, seed)`` — ``fmix32(k ^ seed) mod n_dest``,
  :func:`route_plain` against an empty table (and ``Hash32`` on the host);
* ``RoutingTableDev.from_assignment(assignment, a_max)`` (keys sorted
  ascending, ``INT32_MAX`` padded) — ``RoutingTable.from_arrays(
  *assignment.table_arrays(a_max), device)``, whose ``keys``/``dests`` are
  the same sorted distinct keys and their dests;
* ``route(keys, table, n_dest, seed)`` and ``route_tokens_to_shards`` —
  :func:`route_keys` (the kernel for a CUDA tensor, :func:`route_plain`'s
  binary search for a CPU tensor); ``route(keys, None, ...)`` is
  ``hash_route``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import numpy as np
import torch

from .. import trace
from . import _build
from .ref import fmix32

#: largest table in caller slots that keeps the compact layout below
MAX_TABLE = 16384
#: buckets of two slots a table of at most MAX_TABLE slots may take: 192 KB,
#: small beside the key streams and the 50 MB L2 it is read from
MAX_BUCKETS = 12288
#: home buckets per distinct key, up to MAX_BUCKETS - _OVERFLOW_BUCKETS for a
#: table of at most MAX_TABLE slots, without a cap past it: a quarter-full
#: table, so a lookup seldom reads a second bucket (a warp waits for its
#: slowest lane)
_BUCKETS_PER_KEY = 4
#: buckets kept free of home positions for the chain that runs past the last
#: home bucket, and the one empty bucket that ends every chain
_OVERFLOW_BUCKETS = 64
#: the kernel indexes buckets with int32: the only bound on a table's size
_INT32_BUCKETS = 2**31 - 1
#: the slot hash's salt, fmix32(k ^ _SALT): a mix of its own, so one table
#: serves every routing seed
_SALT = 0x9E3779B9
_SM_COUNT: Dict[int, int] = {}
_M32 = np.uint64(0xFFFFFFFF)


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


def _fmix32_np(x: np.ndarray, salt: int) -> np.ndarray:
    """murmur3's finalizer over uint32 lanes, in uint64 arithmetic."""
    h = (x.astype(np.uint32).astype(np.uint64) ^ np.uint64(salt)) & _M32
    h ^= h >> np.uint64(16)
    h = (h * np.uint64(0x85EBCA6B)) & _M32
    h ^= h >> np.uint64(13)
    h = (h * np.uint64(0xC2B2AE35)) & _M32
    h ^= h >> np.uint64(16)
    return h


def _home_buckets(keys: np.ndarray, salt: int, n_home: int) -> np.ndarray:
    """Each key's home bucket, ``__umulhi(fmix32(k ^ salt), n_home)``."""
    return ((_fmix32_np(keys, salt) * np.uint64(n_home)) >> np.uint64(32)) \
        .astype(np.int64)


def _stable_order(values: np.ndarray) -> np.ndarray:
    """``np.argsort(values, kind="stable")`` for int32-range values, as one
    plain sort of ``value << 32 | index`` (several times faster)."""
    packed = (values.astype(np.int64) << 32) | np.arange(values.size)
    packed.sort()
    return packed & 0xFFFFFFFF


def _place(homes: np.ndarray):
    """Linear probing over two-slot buckets, inserting in home order: the
    order, each key's slot (``max(2 home, previous slot + 1)``, a running
    maximum in closed form) and the longest chain in buckets."""
    order = _stable_order(homes)
    h = homes[order]
    i = np.arange(h.size, dtype=np.int64)
    slot = i + np.maximum.accumulate(2 * h - i)
    return order, slot, int((slot // 2 - h).max()) + 1


class RoutingTable:
    """The override table A of F as the routing kernel probes it.

    ``RoutingTable(table_keys, table_dests)`` takes two int32 tensors of one
    shape (-1 = empty slot) and builds on the host (a tensor on the card is
    copied back first); :meth:`from_arrays` builds from numpy without a host
    sync. Raises ``ValueError`` on duplicate non-negative keys or negative
    dests.

    A table of at most :data:`MAX_TABLE` slots takes at most
    :data:`MAX_BUCKETS` buckets (192 KB); a larger one grows with its keys,
    4 home buckets each, bounded only by the kernel's int32 bucket index.

    Attributes: ``buckets``, the ``(n_buckets, 4)`` int32 table
    ``{key0, dest0, key1, dest1}`` (dest -1 = empty slot) on :attr:`device`;
    ``n_home``, the buckets a key can hash to; ``salt``, the slot hash's;
    ``max_probe``, the longest chain in buckets; ``keys`` and ``dests``, the
    distinct table keys in ascending order with the dest of each one's first
    slot, as host numpy arrays (what :func:`route_plain` searches).
    """

    def __init__(self, table_keys: torch.Tensor, table_dests: torch.Tensor):
        require_int32("routing_lookup", "table_keys", table_keys)
        require_int32("routing_lookup", "table_dests", table_dests)
        if table_keys.dim() != 1 or table_keys.shape != table_dests.shape:
            raise ValueError("table_keys and table_dests must be 1-D tensors "
                             "of one shape")
        if table_keys.device != table_dests.device:
            raise ValueError("table_keys and table_dests must share a device")
        self._build(table_keys.cpu().numpy(), table_dests.cpu().numpy())
        self._upload(table_keys.device)

    @classmethod
    def build(cls, table_keys: np.ndarray,
              table_dests: np.ndarray) -> "RoutingTable":
        """The table on the host (device ``cpu``), from
        ``Assignment.table_arrays`` output (ids must fit int32)."""
        table = cls.__new__(cls)
        table._build(np.asarray(table_keys).astype(np.int32),
                     np.asarray(table_dests).astype(np.int32))
        table._upload(torch.device("cpu"))
        return table

    @classmethod
    def from_arrays(cls, table_keys: np.ndarray, table_dests: np.ndarray,
                    device) -> "RoutingTable":
        """:meth:`build`, then :meth:`to` ``device``."""
        with trace.span("route.build"):
            table = cls.build(table_keys, table_dests)
        with trace.span("route.upload"):
            return table.to(device)

    def _build(self, tk: np.ndarray, td: np.ndarray) -> None:
        if tk.size and int(td.min()) < 0:
            raise ValueError("routing table dests must be >= 0 (the table "
                             "marks its empty slots by dest -1)")
        order = _stable_order(tk)
        ordered = tk[order]
        first = np.ones(tk.size, bool)          # first slot of each key
        np.not_equal(ordered[1:], ordered[:-1], out=first[1:])
        dup = ~first & (ordered >= 0)
        if dup.any():
            raise ValueError(
                f"duplicate routing table key {int(ordered[dup][0])}: F(k) "
                "needs one dest per key (the reference kernels disagree on "
                "duplicates)")
        self.slots = int(tk.size)
        keys = ordered[first]
        self.keys, self.dests = keys, td[order[first]]
        compact = tk.size <= MAX_TABLE
        cap = MAX_BUCKETS if compact else _INT32_BUCKETS
        self.n_home = max(1, min(_BUCKETS_PER_KEY * keys.size,
                                 cap - _OVERFLOW_BUCKETS))
        self.salt = _SALT
        if keys.size:
            order, slot, self.max_probe = _place(
                _home_buckets(keys, self.salt, self.n_home))
        else:
            order, slot, self.max_probe = keys, keys.astype(np.int64), 0
        # one empty bucket past the last full one ends every chain
        n_buckets = max(self.n_home, int(slot[-1]) // 2 + 1 if slot.size
                        else 0) + 1
        if n_buckets > cap:
            raise ValueError(f"routing table overflows {cap} buckets")
        flat = np.zeros(4 * n_buckets, np.int32)
        flat[1::2] = -1
        flat[2 * slot] = keys[order]
        flat[2 * slot + 1] = self.dests[order]
        self._host = torch.from_numpy(flat.reshape(n_buckets, 4))

    def _upload(self, device) -> None:
        device = torch.device(device)
        if device.type != "cuda":
            self.buckets = self._host.to(device)
            return
        # one copy from page-locked memory, queued on the current stream:
        # the host goes on without waiting for it
        pinned = torch.empty(self._host.shape, dtype=torch.int32,
                             pin_memory=True)
        pinned.copy_(self._host)
        self.buckets = pinned.to(device, non_blocking=True)
        self._pinned = pinned          # kept until the table goes

    def to(self, device) -> "RoutingTable":
        """This table with its buckets on ``device`` (the host arrays are
        shared)."""
        table = self.__class__.__new__(self.__class__)
        table.__dict__.update(self.__dict__)
        table._plain = None
        table._upload(device)
        return table

    @property
    def device(self) -> torch.device:
        return self.buckets.device

    def __len__(self) -> int:
        return self.slots

    def sorted_on(self, device) -> tuple:
        """``(keys, dests)`` as int32 tensors on ``device`` (cached)."""
        plain = getattr(self, "_plain", None)
        if plain is None or plain[0].device != torch.device(device):
            plain = (torch.from_numpy(self.keys).to(device),
                     torch.from_numpy(self.dests).to(device))
            self._plain = plain
        return plain


def route_plain(keys: torch.Tensor, table: RoutingTable, n_dest: int,
                seed: int = 0) -> torch.Tensor:
    """Plain PyTorch F(k): hash, then a binary search of the table's sorted
    distinct keys."""
    base = (fmix32(keys, seed) % n_dest).to(torch.int32)
    tkeys, tdests = table.sorted_on(keys.device)
    a = tkeys.numel()
    if a == 0:
        return base
    pos = torch.searchsorted(tkeys, keys).clamp_(max=a - 1)
    hit = tkeys[pos] == keys
    return torch.where(hit, tdests[pos], base)


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = _build.load("routing_lookup")
    fn = lib.routing_lookup_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_uint32, ctypes.c_int, ctypes.c_uint32,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _out_like(keys: torch.Tensor) -> torch.Tensor:
    """An empty int32 tensor of the keys' length at the keys' address mod 16,
    so the kernel's int4 loads and stores line up."""
    n = keys.numel()
    buf = torch.empty(n + 3, dtype=torch.int32, device=keys.device)
    shift = ((keys.data_ptr() - buf.data_ptr()) % 16) // 4
    return buf[shift:shift + n]


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
    out = _out_like(keys)
    n = keys.numel()
    if n == 0:
        return out
    head = min(n, ((-keys.data_ptr()) % 16) // 4)
    vectors = (n - head) // 4
    grid = max(1, min(sm_count(keys.device), -(-vectors // 1024)))
    err = _launcher()(keys.data_ptr(), n, head, table.buckets.data_ptr(),
                      table.buckets.shape[0], table.n_home, table.max_probe,
                      table.salt, n_dest, seed & 0xFFFFFFFF, out.data_ptr(),
                      grid, torch.cuda.current_stream(keys.device).cuda_stream)
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
