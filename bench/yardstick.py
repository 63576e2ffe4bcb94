"""The benchmark's frozen yardstick: the card's published peaks and the
least work of each kernel a metric holds against them.

Peaks of one NVIDIA H100 SXM, from NVIDIA's data sheet (dense rates, no
sparsity, at the full 700 W): copied here, not imported, so that no change
to the program moves them.
"""

from __future__ import annotations

#: device memory bandwidth, bytes/s
HBM_BYTES_PER_S = 3.35e12
#: dense bf16 tensor-core rate, FLOP/s (for the model cells to come)
BF16_FLOPS_PER_S = 989e12


def routing_lookup_bytes(n_keys: int, n_buckets: int) -> int:
    """Least bytes of one ``routing_lookup`` launch: its int32 keys read
    once, its table of ``n_buckets`` buckets of four int32 (two key, dest
    slots) read once, its int32 destinations written once."""
    return 4 * int(n_keys) + 16 * int(n_buckets) + 4 * int(n_keys)


def least_seconds(nbytes: float, flops: float = 0.0,
                  flops_per_s: float = BF16_FLOPS_PER_S) -> float:
    """The least time the card could take: the larger of moving ``nbytes``
    at the memory peak and doing ``flops`` at ``flops_per_s``."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flops_per_s)
