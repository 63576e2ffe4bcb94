"""Blocked causal / sliding-window GQA attention on the card — the
hand-written CUDA kernel and its wrapper.

Port of the JAX package's Pallas ``_flash_kernel``
(``repro/kernels/flash_attention.py``). The kernel is
``csrc/flash_attention.cu``: one CTA per (batch, query head, 64-row query
tile), walking the 64-key tiles its mask reaches with the online-softmax
state in registers; bfloat16 inputs run on the tensor cores
(``mma.sync``), float32 inputs on the CUDA cores. This module checks the
inputs, allocates the output, launches the kernel on PyTorch's current
stream and counts the launch. A
tensor on the CPU takes the plain PyTorch version instead
(:func:`flash_attention_plain`); a CUDA tensor always launches the kernel.

Layout is the JAX package's: q (B, Hq, T, D), k and v (B, Hkv, S, D).
Queries are right-aligned against the keys, float32 accumulation, output in
``q.dtype``. The kernel takes float32 and bfloat16 and head dims up to 256.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import flash_attention as flash_attention_plain

__all__ = ["flash_attention", "flash_attention_plain"]

#: the query and key tile the kernel is compiled for
BLOCK = 64
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + \
        [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention takes q (B, Hq, T, D) and k, v "
                         f"(B, Hkv, S, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, t, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError("q and k/v differ in batch or head dim")
    if k.shape[1] == 0 or hq % k.shape[1]:
        raise ValueError(f"GQA needs Hq ({hq}) to be a multiple of Hkv "
                         f"({k.shape[1]})")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k, v "
                        f"of one dtype (got {q.dtype}, {k.dtype}, "
                        f"{v.dtype})")
    if not q.device == k.device == v.device:
        raise ValueError("q, k and v must share a device")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    block_t: int = BLOCK, block_s: int = BLOCK
                    ) -> torch.Tensor:
    """q: (B, Hq, T, D); k, v: (B, Hkv, S, D); Hq % Hkv == 0. Causal and/or
    sliding-window masked, right-aligned positions (decode friendly).

    ``block_t``/``block_s`` are the query and key tiles; the kernel is
    compiled for 64 x 64 only, and any other value raises ``ValueError``.
    """
    _check(q, k, v)
    if (block_t, block_s) != (BLOCK, BLOCK):
        raise ValueError(f"the flash kernel is built for {BLOCK}x{BLOCK} "
                         f"tiles, not {block_t}x{block_s}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, not "
                         f"{q.device.type}")
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the flash kernel takes head dims up to "
                         f"{MAX_HEAD_DIM}, not {d}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), _DTYPES[q.dtype], b, hq, hkv, t, s, d,
                      int(causal), int(window), d ** -0.5,
                      torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out


#: kernel launches since the count was last set to 0
flash_attention.launches = 0
