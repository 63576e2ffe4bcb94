"""Step-1 per-key statistics g(k) and c(k) on the card — the hand-written
CUDA kernel and its wrapper.

Port of the JAX package's Pallas ``_key_stats_kernel``
(``repro/kernels/key_stats.py``). The kernel is ``csrc/key_stats.cu``:
warp-aggregated float32 adds into zeroed per-key (count, cost) pairs, one
vector atomic a group of lanes that share a key, with a per-block cache in
shared memory for hot keys. The two outputs are the pairs' columns:
(num_keys,) views with stride 2. This module checks the inputs,
allocates the outputs, launches it on PyTorch's current stream and counts
the launch. A tensor on the CPU takes the plain PyTorch version instead
(:func:`key_stats_plain`); a CUDA tensor always launches the kernel.

g(k) is exact while each count stays below 2**24. c(k) is a float32 sum
whose last bits depend on the order the adds land in, which differs from
run to run: within ``2 g(k) 2**-24 |c(k)|`` of the plain version for
non-negative costs (``csrc/key_stats.cu`` derives the bound), inside the
reference's own 1e-6 relative tolerance.

:func:`key_sums`, outside ``__all__``, is the stats path's own two-weight
form: one launch reads the keys once and sums two weight arrays per key.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build
from .ref import key_stats as key_stats_plain
from .routing_lookup import require_int32, sm_count

_BLOCKS_PER_SM = 4
#: weight types the kernel reads as they are; others are cast to float32
_WEIGHT_BYTES = {torch.float32: 4, torch.float64: 8}

__all__ = ["key_stats", "key_stats_plain"]


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = _build.load("key_stats")
    fn = lib.key_stats_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(keys: torch.Tensor, num_keys: int, *weights) -> None:
    require_int32("key_stats", "keys", keys)
    for w in weights:
        if not w.is_floating_point():
            raise TypeError(f"key_stats requires float costs (got {w.dtype})")
        if keys.dim() != 1 or w.shape != keys.shape:
            raise ValueError("keys and costs must be 1-D tensors of one shape")
        if keys.device != w.device:
            raise ValueError("keys and costs must share a device")
    if not 0 <= num_keys < 2**31:
        raise ValueError(f"num_keys must be in [0, 2**31), got {num_keys}")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"key_stats runs on cuda or cpu tensors, not "
                         f"{keys.device.type}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte boundary (the kernel's vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _weights(w: torch.Tensor, like: Optional[torch.Tensor]) -> torch.Tensor:
    """``w`` in a type the kernel reads: float32 or float64 as given (in the
    type of ``like`` when there is one), anything else cast to float32."""
    dtype = like.dtype if like is not None else \
        w.dtype if w.dtype in _WEIGHT_BYTES else torch.float32
    return _aligned(w.to(dtype))


def _launch(keys: torch.Tensor, w1: Optional[torch.Tensor],
            w2: torch.Tensor, num_keys: int) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    # (g, c) pairs, so one vector atomic adds both: the two outputs are
    # the pairs' columns
    out = torch.zeros((num_keys, 2), dtype=torch.float32, device=keys.device)
    n = keys.numel()
    if n == 0 or num_keys == 0:
        return out[:, 0], out[:, 1]
    keys = _aligned(keys)
    w2 = _weights(w2, None)
    if w1 is not None:
        w1 = _weights(w1, w2)
    # a few resident blocks per SM, fewer when the tuples do not fill them
    grid = max(1, min(_BLOCKS_PER_SM * sm_count(keys.device),
                      -(-n // (4 * 512))))
    err = _launcher()(keys.data_ptr(), 0 if w1 is None else w1.data_ptr(),
                      w2.data_ptr(), _WEIGHT_BYTES[w2.dtype], n, num_keys,
                      out.data_ptr(), grid,
                      torch.cuda.current_stream(keys.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"key_stats kernel launch failed: CUDA error {err}")
    key_stats.launches += 1
    return out[:, 0], out[:, 1]


def key_stats(keys: torch.Tensor, costs: torch.Tensor,
              num_keys: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-key frequency and cost over a tuple stream.

    keys: (N,) int32, entries outside ``[0, num_keys)`` ignored; costs: (N,)
    any float dtype, accumulated in float32. Returns ``(freq, cost)``, each
    (num_keys,) float32 on the keys' device (on the card, the two columns
    of one (num_keys, 2) tensor).
    """
    _check(keys, num_keys, costs)
    if keys.device.type == "cpu":
        return key_stats_plain(keys, costs, num_keys)
    return _launch(keys, None, costs, num_keys)


def key_sums(keys: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
             num_keys: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-key sums of two weight arrays over one key stream, in one launch
    on the card (the stats path's c(k) and g(k) from its per-group cost and
    count). Same contract as :func:`key_stats` for each weight; the two
    weights are read in one type (``w2``'s). Returns two (num_keys,)
    float32 tensors. On the CPU: two plain calls."""
    _check(keys, num_keys, w1, w2)
    if keys.device.type == "cpu":
        return (key_stats_plain(keys, w1, num_keys)[1],
                key_stats_plain(keys, w2, num_keys)[1])
    return _launch(keys, w1, w2, num_keys)


#: kernel launches since the count was last set to 0 (both entry points)
key_stats.launches = 0
