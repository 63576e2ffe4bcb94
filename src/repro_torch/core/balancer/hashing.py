"""Base hash h: K -> D of the mixed assignment F (paper Sec. II, Eq. 1).

Only the device-canonical router is ported: :class:`Hash32`, the murmur3
32-bit finalizer then mod N_D. The routing kernel
(``repro_torch/csrc/routing_lookup.cu``) and its plain PyTorch version
(``repro_torch.kernels.ref.fmix32``) implement exactly this mix, so the host
planner and the data plane agree bit for bit.
"""

from __future__ import annotations

import numpy as np

from .types import HashRouter

#: seed spacing wherever a family of independent fmix32 draws is needed (the
#: count-min sketch's rows): the golden-ratio odd constant. fmix32
#: decorrelates any two seeds; this just keeps them distinct per row.
GOLDEN_SEED_STRIDE = 0x9E3779B9


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
