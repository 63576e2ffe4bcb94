"""Plain PyTorch versions of the JAX package's kernel oracles (its
``kernels/ref.py``): the correctness ground truth the port's kernels and
their wrappers are held against.

:func:`flash_attention` follows the Pallas kernel where the JAX oracle
differs from it: a query row that admits no key gives 0 there (the kernel
divides by ``max(l, 1e-30)``), where the oracle's softmax over all ``-inf``
gives NaN.

torch cannot shift ``uint32`` on the CPU, so the 32-bit mix works in int64
with ``& 0xFFFFFFFF`` after every step; each 32x32-bit product is split into
16-bit halves so no intermediate leaves the int64 range.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """Low 32 bits of ``h * c`` for ``h``, ``c`` in [0, 2**32), in int64:
    ``h * (c & 0xFFFF)`` stays below 2**48 and only the low 16 bits of
    ``h * (c >> 16)`` survive the shift."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def fmix32(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """murmur3 finalizer over the uint32 view of ``x``; int64 in [0, 2**32)
    out, bit-identical to ``Hash32``'s numpy mix."""
    h = (x.to(torch.int64) & _M32) ^ (seed & _M32)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def key_stats(keys: torch.Tensor, costs: torch.Tensor, num_keys: int):
    """Per-key tuple frequency g(k) and cost c(k) over one interval's stream.

    keys: (N,) int32; costs: (N,) float. Keys outside ``[0, num_keys)`` are
    padding and ignored. Returns two (num_keys,) float32 tensors.
    """
    valid = (keys >= 0) & (keys < num_keys)
    k = keys[valid].to(torch.int64)
    freq = torch.zeros(num_keys, dtype=torch.float32, device=keys.device)
    cost = torch.zeros(num_keys, dtype=torch.float32, device=keys.device)
    freq.index_add_(0, k, torch.ones(k.shape, dtype=torch.float32,
                                     device=keys.device))
    cost.index_add_(0, k, costs[valid].to(torch.float32))
    return freq, cost


def routing_lookup(keys: torch.Tensor, table_keys: torch.Tensor,
                   table_dests: torch.Tensor, n_dest: int,
                   seed: int = 0) -> torch.Tensor:
    """Mixed routing F(k) (paper Eq. 1): table override else hash.

    table_keys: (A,) int32, -1 = empty slot. A brute-force (N, A) compare;
    on duplicate table keys the FIRST matching slot wins. Returns int32.
    """
    base = (fmix32(keys, seed) % n_dest).to(torch.int32)
    hit = keys[:, None] == table_keys[None, :]
    any_hit = hit.any(dim=1)
    slot = hit.to(torch.int32).argmax(dim=1)
    return torch.where(any_hit, table_dests[slot], base).to(torch.int32)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """GQA attention, the semantics of the Pallas ``_flash_kernel``.

    q: (B, Hq, T, D); k, v: (B, Hkv, S, D), Hq % Hkv == 0. Scale ``D**-0.5``;
    query ``i`` sits at position ``i + S - T`` (right-aligned); key ``j`` is
    admitted when ``j <= pos`` (causal) and ``j > pos - window``
    (``window > 0``). float32 arithmetic, output in ``q.dtype``; a row with
    no admitted key is 0.
    """
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, t, d).to(torch.float32)
    logits = torch.einsum("bkgtd,bksd->bkgts", qg,
                          k.to(torch.float32)) * d ** -0.5
    q_pos = torch.arange(t, device=q.device)[:, None] + (s - t)
    k_pos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((t, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    logits = logits.masked_fill(~mask, float("-inf"))
    # a fully masked row has max -inf; -1e30 keeps exp(-inf - m) at 0
    m = logits.amax(dim=-1, keepdim=True).clamp(min=-1e30)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgts,bksd->bkgtd", p, v.to(torch.float32))
    out = out / l.clamp(min=1e-30)
    return out.reshape(b, hq, t, d).to(q.dtype)
