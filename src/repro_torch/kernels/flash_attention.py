"""Blocked causal / sliding-window GQA attention on the card — the
hand-written CUDA kernel and its wrapper.

Port of the JAX package's Pallas ``_flash_kernel``
(``repro/kernels/flash_attention.py``). The kernel is
``csrc/flash_attention.cu``: one CTA per (batch, query head, query tile),
walking the 64-key tiles its mask reaches with the online-softmax state in
registers. bfloat16 inputs run on Hopper's tensor cores: ``wgmma`` fed by a
ring of TMA loads, one producer and two consumer warpgroups, 128 query
rows per CTA. float32 inputs run on the CUDA cores, 64 query rows per CTA.
This module checks the inputs, allocates the output, launches the kernel
on PyTorch's current stream and counts the launch. A tensor on the CPU
takes the plain PyTorch version instead (:func:`flash_attention_plain`); a
CUDA tensor always launches the kernel.

TMA reads rows that are 16-byte aligned and 16 bytes apart, so for
bfloat16 the wrapper zero-pads a head dim that is not a multiple of 8 (the
scale stays ``D**-0.5`` of the real D, and the output is sliced back) and
copies an input whose storage is not 16-byte aligned.

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

#: the Pallas kernel's default tiles, the only ``block_t``/``block_s`` the
#: wrapper takes (the CUDA kernel fixes its own: 64 query rows x 64 keys in
#: float32, 128 query rows x 64 keys in bfloat16)
BLOCK = 64
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: bfloat16 rows go through TMA: 16-byte aligned, a multiple of 16 bytes
_TMA_ALIGN = 16
_TMA_COLS = 8


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

    ``block_t``/``block_s`` are the Pallas kernel's tile arguments; the
    CUDA kernel's tiles are fixed, and any value but 64 raises
    ``ValueError``.
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
    if q.numel() == 0:
        return torch.empty_like(q)
    scale = d ** -0.5
    if q.dtype == torch.bfloat16:
        q, k, v = (_tma_ready(x) for x in (q, k, v))
    else:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    err = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), _DTYPES[q.dtype], b, hq, hkv, t, s,
                      q.shape[3], int(causal), int(window), scale,
                      torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out if out.shape[3] == d else out[..., :d].contiguous()


def _tma_ready(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous, its head dim zero-padded to a multiple of 8 and
    its storage 16-byte aligned, copying only where it is not already."""
    d = x.shape[-1]
    if d % _TMA_COLS:
        x = torch.nn.functional.pad(x, (0, _TMA_COLS - d % _TMA_COLS))
    x = x.contiguous()
    if x.data_ptr() % _TMA_ALIGN:
        x = x.clone()
    return x


#: kernel launches since the count was last set to 0
flash_attention.launches = 0
