"""Step-1 per-key statistics g(k) and c(k) on the card — the hand-written
CUDA kernel and its wrapper.

Port of the JAX package's Pallas ``_key_stats_kernel``
(``repro/kernels/key_stats.py``). The kernel is ``csrc/key_stats.cu``: one
thread per tuple, float32 ``atomicAdd`` into zeroed per-key outputs. This
module checks the inputs, allocates the outputs, launches it on PyTorch's
current stream and counts the launch. A tensor on the CPU takes the plain
PyTorch version instead (:func:`key_stats_plain`); a CUDA tensor always
launches the kernel.

g(k) is exact while each count stays below 2**24. c(k) is a float32 sum
whose last bits depend on the order the atomics land in, which differs from
run to run: within the reference's own 1e-6 relative tolerance.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build
from .ref import key_stats as key_stats_plain
from .routing_lookup import require_int32, sm_count

_BLOCK = 256
_BLOCKS_PER_SM = 8

__all__ = ["key_stats", "key_stats_plain"]


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = _build.load("key_stats")
    fn = lib.key_stats_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def key_stats(keys: torch.Tensor, costs: torch.Tensor,
              num_keys: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-key frequency and cost over a tuple stream.

    keys: (N,) int32, entries outside ``[0, num_keys)`` ignored; costs: (N,)
    any float dtype, accumulated in float32. Returns ``(freq, cost)``, each
    (num_keys,) float32 on the keys' device.
    """
    require_int32("key_stats", "keys", keys)
    if not costs.is_floating_point():
        raise TypeError(f"key_stats requires float costs (got {costs.dtype})")
    if keys.dim() != 1 or costs.shape != keys.shape:
        raise ValueError("keys and costs must be 1-D tensors of one shape")
    if keys.device != costs.device:
        raise ValueError("keys and costs must share a device")
    if not 0 <= num_keys < 2**31:
        raise ValueError(f"num_keys must be in [0, 2**31), got {num_keys}")
    if keys.device.type == "cpu":
        return key_stats_plain(keys, costs, num_keys)
    if keys.device.type != "cuda":
        raise ValueError(f"key_stats runs on cuda or cpu tensors, not "
                         f"{keys.device.type}")
    keys = keys.contiguous()
    costs = costs.to(torch.float32).contiguous()
    freq = torch.zeros(num_keys, dtype=torch.float32, device=keys.device)
    cost = torch.zeros(num_keys, dtype=torch.float32, device=keys.device)
    n = keys.numel()
    if n == 0 or num_keys == 0:
        return freq, cost
    grid = min(-(-n // _BLOCK), _BLOCKS_PER_SM * sm_count(keys.device))
    err = _launcher()(keys.data_ptr(), costs.data_ptr(), n, num_keys,
                      freq.data_ptr(), cost.data_ptr(), grid, _BLOCK,
                      torch.cuda.current_stream(keys.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"key_stats kernel launch failed: CUDA error {err}")
    key_stats.launches += 1
    return freq, cost


#: kernel launches since the count was last set to 0
key_stats.launches = 0
