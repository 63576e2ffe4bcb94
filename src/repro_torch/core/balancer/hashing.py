"""Base hash h: K -> D of the mixed assignment F (paper Sec. II, Eq. 1).

* :class:`Hash32` — the murmur3 32-bit finalizer then mod N_D, the
  device-canonical router: the routing kernel
  (``repro_torch/csrc/routing_lookup.cu``) and its plain PyTorch version
  (``repro_torch.kernels.ref.fmix32``) implement exactly this mix, so the
  host planner and the data plane agree bit for bit.
* :class:`ModHash` — splitmix64 then mod N_D, host only (no 64-bit mix on
  the data plane), so stages on it take the numpy substrate and the
  columnar store.
* :class:`ExplicitHash` — a fixed key -> dest mapping over a ModHash
  fallback (tests, the paper's worked examples).
* :class:`ConsistentHash` — a ring with virtual nodes: when ``n_dest``
  changes (elastic scale-out, paper Fig. 15) only ~K/N_D keys remap.
"""

from __future__ import annotations

import numpy as np

from .types import HashRouter

_U64 = np.uint64

#: seed spacing wherever a family of independent fmix32 draws is needed
#: (choice-router candidates, the count-min sketch's rows): the golden-ratio
#: odd constant. fmix32 decorrelates any two seeds; this just keeps them
#: distinct per candidate or row.
GOLDEN_SEED_STRIDE = 0x9E3779B9


def splitmix64(x: np.ndarray, seed: int = 0x9E3779B97F4A7C15) -> np.ndarray:
    """Vectorized splitmix64 finalizer, uint64 in and out."""
    with np.errstate(over="ignore"):
        z = x.astype(_U64) + _U64(seed)
        z = (z ^ (z >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> _U64(27))) * _U64(0x94D049BB133111EB)
        z = z ^ (z >> _U64(31))
    return z


def fmix32(x: np.ndarray, seed: int = 0) -> np.ndarray:
    """Vectorized murmur3 finalizer (32-bit), uint32 in and out."""
    with np.errstate(over="ignore"):
        h = x.astype(np.uint32) ^ np.uint32(seed & 0xFFFFFFFF)
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
    return h


class Hash32(HashRouter):
    """Device-compatible router: fmix32 then mod N_D. Keys must fit uint32."""

    def __init__(self, n_dest: int, seed: int = 0):
        if n_dest <= 0:
            raise ValueError("n_dest must be positive")
        self.n_dest = int(n_dest)
        self.seed = int(seed)

    def __call__(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys).astype(np.int64, copy=False)
        h = fmix32((keys & 0xFFFFFFFF).astype(np.uint32), self.seed)
        return (h % np.uint32(self.n_dest)).astype(np.int64)

    def with_n_dest(self, n_dest: int) -> "Hash32":
        return Hash32(n_dest, self.seed)


class ModHash(HashRouter):
    """splitmix64 of ``key ^ seed`` then mod N_D (any int64 key)."""

    def __init__(self, n_dest: int, seed: int = 0):
        if n_dest <= 0:
            raise ValueError("n_dest must be positive")
        self.n_dest = int(n_dest)
        self.seed = int(seed)

    def __call__(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys).astype(np.int64, copy=False)
        h = splitmix64(keys.view(_U64) ^ _U64(self.seed & 0xFFFFFFFFFFFFFFFF))
        return (h % _U64(self.n_dest)).astype(np.int64)

    def with_n_dest(self, n_dest: int) -> "ModHash":
        return ModHash(n_dest, self.seed)


class ExplicitHash(HashRouter):
    """Fixed key->dest mapping (tests / paper worked examples). Keys outside
    the mapping fall back to ModHash."""

    def __init__(self, mapping: dict, n_dest: int, seed: int = 0):
        self.n_dest = int(n_dest)
        self.mapping = dict(mapping)
        self._fallback = ModHash(n_dest, seed)
        self.seed = seed

    def __call__(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys).astype(np.int64, copy=False)
        out = self._fallback(keys)
        for i, k in enumerate(keys.ravel()):
            if int(k) in self.mapping:
                out.ravel()[i] = self.mapping[int(k)]
        return out

    def with_n_dest(self, n_dest: int) -> "ExplicitHash":
        return ExplicitHash(self.mapping, n_dest, self.seed)


class ConsistentHash(HashRouter):
    """Hash ring with ``vnodes`` virtual nodes per destination."""

    def __init__(self, n_dest: int, vnodes: int = 64, seed: int = 0):
        if n_dest <= 0:
            raise ValueError("n_dest must be positive")
        self.n_dest = int(n_dest)
        self.vnodes = int(vnodes)
        self.seed = int(seed)
        ids = np.arange(n_dest * vnodes, dtype=np.int64)
        # ring position of virtual node j of dest d: mix(d * vnodes + j, seed+1)
        ring = splitmix64(ids.view(_U64) ^ _U64((seed + 1) & 0xFFFFFFFFFFFFFFFF))
        order = np.argsort(ring)
        self._ring = ring[order]
        self._ring_dest = (ids[order] // vnodes).astype(np.int64)

    def __call__(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys).astype(np.int64, copy=False)
        h = splitmix64(keys.view(_U64) ^ _U64(self.seed & 0xFFFFFFFFFFFFFFFF))
        pos = np.searchsorted(self._ring, h, side="left")
        pos = np.where(pos == len(self._ring), 0, pos)  # wrap around the ring
        return self._ring_dest[pos]

    def with_n_dest(self, n_dest: int) -> "ConsistentHash":
        return ConsistentHash(n_dest, self.vnodes, self.seed)
