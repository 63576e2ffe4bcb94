"""The ``REPRO_PERF_*`` environment flags, read as the JAX package reads them.

Each flag turns on one layout or precision choice at the point where the
JAX package reads it, so an environment means the same thing in both
packages. A flag is on when its variable is exactly ``"1"``; with none set
every path is the default one.

* ``MOE_GROUPED`` (``models.moe``): one dispatch group per data shard of
  the installed mesh; capacity, sort and rank per group.
* ``DECODE_WS`` (``models.transformer``): at decode (a cache, T = 1) the
  activation's embed dim is split over "data" for the layer, so the
  projections contract a data-split dim instead of gathering the FSDP
  weights.
* ``ATTN_SHARD`` (``models.attention``): ("dp", "tp") pins on q, k and v.
* ``DEFER_GRAD_SYNC`` (``train.train_step``): the microbatch gradients
  stay unreduced over the data axes and are reduced once after the loop.
* ``BF16_ACCUM`` (``train.train_step``): the gradient accumulators in
  bfloat16.
* ``WINDOW_SLICE`` (``models.attention``): a sliding-window layer's query
  chunk reads only its key band.
* ``BF16_LOSS`` (``models.transformer``): the logits cast to bfloat16
  before the vocabulary-padding mask and the float32 logsumexp.

The launchers (``launch.serve``, ``launch.train``) ``setdefault`` the JAX
launchers' flags for their run unless given ``--no-perf-flags``
(:func:`launcher_defaults_set`).
"""

from __future__ import annotations

import contextlib
import os

NAMES = ("MOE_GROUPED", "DECODE_WS", "ATTN_SHARD", "DEFER_GRAD_SYNC",
         "BF16_ACCUM", "WINDOW_SLICE", "BF16_LOSS")

#: the archs whose heads do not divide the production mesh's "model" axis:
#: the JAX training launcher turns ``ATTN_SHARD`` on for these
ATTN_SHARD_ARCHS = ("qwen2_7b", "whisper_large_v3", "internvl2_1b",
                    "granite_moe_3b_a800m", "xlstm_125m")


def enabled(name: str) -> bool:
    """Whether ``REPRO_PERF_<name>`` is set to ``"1"``."""
    if name not in NAMES:
        raise KeyError(f"unknown perf flag {name!r}; one of {NAMES}")
    return os.environ.get(f"REPRO_PERF_{name}", "0") == "1"


def launcher_defaults(launcher: str, arch: str) -> tuple:
    """The flags the JAX launcher ``launcher`` ("serve" or "train") turns on
    for ``arch`` (underscored)."""
    if launcher == "serve":
        return ("DECODE_WS", "MOE_GROUPED")
    if launcher == "train":
        return ("MOE_GROUPED",) + (("ATTN_SHARD",)
                                   if arch in ATTN_SHARD_ARCHS else ())
    raise ValueError(launcher)


@contextlib.contextmanager
def launcher_defaults_set(launcher: str, arch: str, enable: bool = True):
    """Within the block, ``os.environ.setdefault`` each of
    :func:`launcher_defaults` to "1" (a variable already set keeps its
    value; nothing when not ``enable``, ``--no-perf-flags``); on leaving,
    the variables it set are removed again, so a launcher called in a
    longer-lived process leaves its environment as it found it."""
    added = []
    if enable:
        for name in launcher_defaults(launcher, arch):
            var = f"REPRO_PERF_{name}"
            if var not in os.environ:
                os.environ[var] = "1"
                added.append(var)
    try:
        yield
    finally:
        for var in added:
            os.environ.pop(var, None)
