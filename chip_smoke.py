#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit (``nvcc``)::

    python3 chip_smoke.py

It prints one JSON line per phase, each with its wall seconds:

* ``build``   — compiles the CUDA kernels (one ``nvcc`` per source, all
  started together); the card, its power limit, the torch/CUDA/nvcc
  versions and what ``ptxas`` reports per kernel.
* ``kernels`` — each kernel against its plain PyTorch version on the card,
  at the shapes the configurations below give it plus edge cases,
  timed with CUDA events (median of 25 launches, L2 flushed before each).
  Every row carries ``bound_share`` (``bound_ms / ms``: 1 would be the
  card's peak); the flash rows also ``tflops`` (the mask's 4 D FLOPs per
  admitted (query, key) pair over the kernel's time), and the stats-path
  row the two-weight launch that the stats path makes (``two_weight``).
* ``stream``  — the main path, ``KeyedStage(state_backend="device",
  substrate="kernels")`` on the card: WordCount at the paper's Table II
  defaults (z = 0.85, f = 1.0, 15 tasks, theta_max = 0.08, A_max = 3000),
  K = 10^6 keys, window 5, 4M tuples per interval, 8 intervals. The same
  stream through ``state_backend="columnar", substrate="numpy"`` on the CPU
  must give identical reports, outputs and routing tables. The dense
  route's time (``route_dense_ms``) is split into the routing table's build
  on the host, its upload and the kernel (``route_dense_parts_ms``).
* ``stats``   — the stats path, ``KeyedStage(state_backend="columnar",
  substrate="kernels")`` on the card, for the stream's first 4 intervals,
  against the same CPU reports (float32 stats: 1e-6 relative).
* ``stream_sketch`` — the stream deployment with
  ``RebalanceController(stats_mode="sketch")`` (count-min sketch and
  SpaceSaving head tracker, the default ``SketchConfig``): Mixed for 8
  intervals, then MinTable, MinMig and compact Mixed for 2 each, each held
  interval by interval against the same planner's sketch-mode stage on the
  CPU (``SKETCH_ORACLE``). Per planner: interval, plan and ``ingest`` ms,
  tuples/s, the snapshot's head keys (beside the exact phase's stats
  keys), the sketch's bytes, θ and the routing kernel's launches, which
  must cover every assignment version the stage routed with. Its routing
  table and dense domain also give the kernel a row of its own.
* ``chaos``   — the rest of the stream system at the stream cell's
  deployment, in three legs. (1) Recovery on the device ring
  (``substrate="kernels"``): the stream phase's 8 intervals of traffic,
  through a fault-free stage and through an identical one under
  ``ChaosRunner(checkpoint_every=2)`` with ``CHAOS_PLAN`` (kills at both
  crash sites, a dropped and a duplicated delivery, a stall of 2
  attempts); the reports (every field, task loads included), outputs,
  emitted sum and held keys must be identical, with one
  ``RecoveryEvent`` a fault. Read: each event's time to recover (restore
  plus replay, from the caught fault until the stage is back at the
  interval), intervals replayed, each cadence checkpoint's ms and host
  bytes, and the chaos run's wall time against the fault-free run's. (2)
  ``AutoscaleLoop`` on the device ring from 15 tasks (target 4M/15 a
  task, 4 to 15 tasks) through 1M x 4, 4M x 5, 1M x 5 tuples (prefixes of
  those intervals), against the same loop on a CPU columnar stage:
  identical decisions and reports, no task flagged, a scale-in and a
  scale-out applied; read each decision's predicted bytes and stall and
  ``scale_to``'s ms. (3) The object store
  (``state_backend="object"``, ``substrate="kernels"``): WindowedSelfJoin
  over float ticks at K = 10^5, 500K tuples x 4 (``ObjectLegConfig``)
  against the per-tuple loop (``vectorized=False``, numpy, CPU):
  identical outputs and emitted sum, loads within 1e-5 and c(k) within
  1e-6 relative. Routing must launch at least once per assignment
  version each recovery-leg run routes with; in the object leg both
  kernels launch every interval. Rows ``routing_lookup[dense,chaos]``,
  ``routing_lookup[per_tuple,object]`` and ``key_stats[object]``.
* ``serve``   — the serving slice: gemma3-12b at full width and depth
  (48 layers, d_model 3840, 16/8 heads of 240, vocab 262144) with random
  bf16 weights from a seeded generator on the card, 4 requests of 2048
  prompt tokens. (1) the cache-free step ``make_serve_step(cfg,
  use_flash=True)``, which must launch the flash kernel once per layer
  (40 windowed, 8 global), each output held against the plain version on
  the same q, k, v; (2) the same step with ``use_flash=False``, whose
  logits must agree with (1) within atol 0.3 / rtol 0.05 (the JAX
  package's serve tolerance); (3) prefill through the KV cache and 16
  greedy tokens, each step timed, then ``serve_local``, which does the
  same: neither may launch the flash kernel, and ``serve_local``'s first
  token must equal (1)'s argmax wherever (1)'s top-1 margin exceeds twice
  the gap measured in (2). (4) The window-slice leg on the same weights
  (``window_loss_leg``): the first superblock (5 sliding-window layers and
  a global one) at full width in float32, ``lm_loss`` forward over 1 x
  4096 tokens through the plain attention, with no flag, with
  ``REPRO_PERF_WINDOW_SLICE`` and with it and ``REPRO_PERF_BF16_LOSS``:
  the sliced loss within ``WINDOW_LEG_RTOL`` of the plain one (1e-4),
  the bfloat16-logits loss within 5e-3 (ROADMAP C11); each run's ms and
  peak bytes.
* ``serve_moe`` — the MoE serving slice: granite-moe-3b-a800m at full
  width and depth (32 layers, d_model 1536, 24/8 heads of 64, 40 experts
  top-8 of d_ff 512, vocab 49155), random bf16 weights, the same 4 x 2048
  prompt tokens. (1) the cache-free flash step under identity placements:
  32 flash launches, each output held against the plain version; (2) the
  plain-attention step, whose logits gap to (1) is reported beside the
  routed entries that moved between the two (the logits must agree within
  atol 0.3 / rtol 0.05 only where none moved); (3) the expert loads of
  every layer, which must sum to tokens x top-k; (4) one SkewShield placer
  per layer updated from its loads (one expert per layer made 8x hotter if
  no layer moves one); (5) the expert weights permuted on the card, then
  step (1) under the new placements, whose logits must equal (1)'s; (6)
  prefill through the KV cache and 16 timed greedy decode steps under the
  new placements, neither launching the flash kernel. Also one MoE layer's
  time split into its expert products and the rest.
* ``train`` — the training slice (``TrainPhaseConfig``): granite-moe-3b-
  a800m at full width and depth, random bf16 weights and AdamW state on
  the card, ``Trainer`` for 6 steps of 8 x 512 tokens from the keyed data
  pipeline, 2 microbatches, SkewShield every 2 steps. Every loss and grad
  norm must be finite; at each rebalance every placer must be handed the
  step's loads by logical expert, and where experts moved, the loss of a
  fixed batch must be bit-identical before and after the move (weights,
  moments and placements moved together). Read: step ms, tokens/s,
  ``opt_update`` and loss-and-backward ms, each rebalance's ms, moves and
  theta, peak memory beside ``memory_arithmetic``. Then the resume leg at
  full width cut to 2 layers (4 steps straight against 2, ``save``, a
  fresh trainer's ``try_resume`` and 2 more: placements, routing tables,
  losses and every tensor bit-identical; checkpoint bytes, save and
  restore ms) and one float32 step of that model on the card and on the
  CPU (``CARD_CPU_TOL``; the routed entries that differ are counted, and
  the loss is held only where none do). No kernel may launch.

* ``large_table`` — a routing table past the compact layout's 16,384
  slots (``LargeTableConfig``, ROADMAP C13): the stream deployment's
  WordCount on the device ring (``substrate="kernels"``) with 24,000 keys
  installed (32,768 slots once padded), 3 intervals of 1M tuples, against
  the CPU columnar stage with the same table: reports, outputs and the
  dense dest table of every key id identical; row
  ``routing_lookup[dense,large_table]``.
* ``sharded`` — the stream cell's deployment on
  ``state_backend="sharded"`` (``substrate="kernels"``) over a one-rank
  NCCL group (a ``FileStore`` in a temporary directory, no network)
  against a ``device`` stage on the same traffic (the stream phase's 8
  intervals of keys): 8 intervals, a ``scale_to`` to 17 tasks, a
  checkpoint, 2 intervals, the restore and the replay of those 2. Reports, outputs, emitted sum, routing tables and the
  dense routes identical; ``all_to_all_single`` once an interval; the
  routing kernel at least once per assignment version. Read: interval ms
  beside the device stage's, the collective's ms (host-timed between two
  synchronisations), ``scale_to``, checkpoint and restore ms, peak memory;
  row ``routing_lookup[dense,sharded]`` on this rank's key block.
* ``serve_arch`` — once for each of ``ARCH_SERVES`` (whisper-large-v3,
  internvl2-1b, xlstm-125m, qwen2-7b, granite-8b, granite-20b) at full
  width and depth, random bf16 weights, 4 requests (2048 prompt tokens
  for the three dense archs): the cache-free step with flash (one launch
  per decoder attention layer, each output held against the plain
  version; 0 for xlstm), the same step without flash, the cached prefill
  (whisper's frames encoded once; internvl2's 256-token prefix before the
  prompt) and 16 timed greedy decode steps (none may launch flash). The
  logits gaps (flash against plain, cached prefill against both) are
  reported against atol 0.3 / rtol 0.05 (secondary, ROADMAP C3); the
  parameter count must equal the schema's. Then a flash row at each
  shape that launched it (``arch_flash_rows``).
* ``mamba`` — one jamba-1.5-large-398b mamba layer at full width
  (``MambaPhaseConfig``): a bf16 prefill of 2048 tokens (ms, tokens/s,
  peak memory above its inputs beside the (B, T, Di, N) float32 tensor's
  bytes) and 16 decode steps; in float32, a prefill of 2032 tokens and 16
  one-token steps against the full scan on the card, and the card against
  the CPU at 128 tokens, each within 1e-4 of the largest value.
* ``train_archs`` — ``lm_loss`` and one float32 train step (2
  microbatches) of jamba, xlstm, whisper and internvl2 at smoke size on
  the card and on the CPU: finite, and within ``CARD_CPU_TOL``.
* ``mesh`` — the model on DTensors under a device mesh
  (``MeshPhaseConfig``): a one-rank (1, 1) ("data", "model") NCCL
  ``DeviceMesh`` (the ``sharded`` phase's ``FileStore`` rendezvous),
  granite-moe-3b-a800m at full width and depth from ``serve_moe``'s
  weights, laid out by ``param_shardings`` (FSDP). (1) The cache-free
  flash step at 4 x 2048 tokens under ``sharding.ctx.use_mesh``: the
  flash kernel once per attention layer on the local shards, each launch
  held against the plain version; its logits against the same step
  without the mesh in this call (a one-rank mesh runs the same local
  code, so the gap is expected to be 0; a nonzero gap is reported and
  held to atol 0.3 / rtol 0.05). (2) The cached prefill and 16 greedy
  tokens, on a cache laid out by ``cache_shardings``: the tokens must
  equal the unsharded run's. (3) One float32 train step of 2
  microbatches at full width cut to ``train_layers`` layers, against the
  same step without the mesh within ``CARD_CPU_TOL``, at the ``train``
  phase's 8 x 512 tokens, with the same routing (a routed entry that moved
  fails the phase), returning every leaf in the placements it was given.
  (2b) The serve launcher's flags (``REPRO_PERF_DECODE_WS``,
  ``REPRO_PERF_MOE_GROUPED``) on the mesh: the cache-free flash step (once
  per layer), the cached prefill and the 16 greedy tokens must be bit for
  bit the flag-free mesh steps' (one rank: one dispatch group, and no
  "data" split for the decode pin). (3b) The train step with the train
  launcher's flags and ``REPRO_PERF_DEFER_GRAD_SYNC``: bit for bit the
  flag-free mesh step; with ``REPRO_PERF_BF16_ACCUM`` too: finite, the same
  loss, the masters' gap reported, not gated.
  Read: the phase's wall time, each mesh step's time over the unsharded
  step's (what DTensor dispatch costs), peak memory; row
  ``flash_attention[global,mesh]``, timed on the q, k, v of the mesh
  step's last flash launch.

Then one ``{"kernels": [...]}`` line (per kernel and call site: launches on
its path, max error, kernel/plain/library times and the bound), the card's
name and power limit as ``nvidia-smi`` gives them, and last
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
before that line; so does a machine without a CUDA device or a checkout
without ``src/repro_torch``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
#: H100 SXM peaks (NVIDIA data sheet, 700 W): device-memory rate; the
#: non-tensor-core float32 rate, taken for the stream kernels' 32-bit integer
#: and float operations; and the dense bf16 tensor-core rate, taken for
#: attention's multiply-adds (the least time the card could take for them)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
#: 32-bit operations per key of the routing kernel: the hash dest (the
#: fmix32 mix, 9, and the modulo), the slot's mix and range (10) and one
#: probe of a bucket (load, two compares, select: 4); at least one probe a
#: key, so this is the least work
ROUTE_OPS_PER_KEY = 24
#: per tuple of key_stats: two range tests and two adds
STATS_OPS_PER_TUPLE = 4
REPORT_FIELDS = ("interval", "tuples", "makespan", "migration_stall",
                 "throughput", "skewness", "theta", "migrated_bytes",
                 "table_size", "buffered")


@dataclasses.dataclass(frozen=True)
class Config:
    """One deployment: the paper's Table II defaults as the JAX package's
    benchmarks encode them, at the largest exact-stats key domain of its
    key-domain sweep (K = 10^6)."""

    k: int = 1_000_000
    z: float = 0.85
    f: float = 1.0
    n_tasks: int = 15
    theta_max: float = 0.08
    table_max: int = 3000
    seed: int = 0
    window: int = 5
    tuples: int = 4_000_000
    intervals: int = 8
    stats_intervals: int = 4
    table_capacity: int = 4096
    reps: int = 25


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The serving deployment: gemma3-12b at full width, a batch of 4
    requests of 2048 prompt tokens (twice the local layers' 1024 window),
    16 greedy tokens each."""

    arch: str = "gemma3-12b"
    batch: int = 4
    prompt: int = 2048
    tokens: int = 16
    seed: int = 0
    #: the JAX package's serve-path tolerance (tests/test_arch_smoke.py)
    atol: float = 0.3
    rtol: float = 0.05
    #: the window-slice leg (``window_loss_leg``): its superblocks of the
    #: model and its tokens (1 x 4096: at 2048 the band is not taken,
    #: window 1024 + chunk 1024 = S)
    window_groups: int = 1
    window_seq: int = 4096


@dataclasses.dataclass(frozen=True)
class MoeServeConfig:
    """The MoE serving deployment: granite-moe-3b-a800m at full width and
    depth, 4 requests of 2048 prompt tokens, 16 greedy tokens each, one
    SkewShield placer per layer sized as the JAX package's serving example
    sizes them (4 expert shards, theta_max 0.15, an expert's three bf16
    matrices as its migration bytes)."""

    arch: str = "granite-moe-3b-a800m"
    batch: int = 4
    prompt: int = 2048
    tokens: int = 16
    seed: int = 0
    shards: int = 4
    theta_max: float = 0.15
    #: when no layer's measured loads move an expert, one expert per layer
    #: has its load multiplied by this, so the permutation always runs
    hot_factor: float = 8.0
    #: repetitions of the host-timed MoE breakdown (median)
    reps: int = 5
    atol: float = 0.3
    rtol: float = 0.05


@dataclasses.dataclass(frozen=True)
class TrainPhaseConfig:
    """The training deployment: granite-moe-3b-a800m at full width and
    depth, 8 sequences of 512 tokens a step from the keyed data pipeline
    (32 Zipf sources, z = 1, one worker: the training launcher's local
    mode), 2 microbatches, a SkewShield rebalance every 2 steps (theta_max
    0.02, low enough that the measured loads move experts), 6 steps.
    Then a resume leg at full width cut to 2 layers (4 steps straight
    against 2, a save, a fresh trainer's resume and 2 more), and one
    float32 train step of the same 2-layer model on the card and on the
    CPU."""

    arch: str = "granite-moe-3b-a800m"
    batch: int = 8
    seq: int = 512
    microbatches: int = 2
    steps: int = 6
    rebalance_every: int = 2
    theta_max: float = 0.02
    seed: int = 0
    lr: float = 1e-3
    warmup_steps: int = 2
    sources: int = 32
    docs_per_interval: int = 32
    #: the resume leg: its depth and its steps (the save after half)
    resume_layers: int = 2
    resume_steps: int = 4
    #: the card-against-CPU step (float32, ``resume_layers`` layers)
    cpu_batch: int = 2
    cpu_seq: int = 128


@dataclasses.dataclass(frozen=True)
class MeshPhaseConfig:
    """The mesh deployment: granite-moe-3b-a800m at full width and depth
    on a one-rank (1, 1) ("data", "model") mesh, from ``serve_moe``'s
    weights (its seed), 4 requests of 2048 prompt tokens and 16 greedy
    tokens; the train step at full width cut to ``train_layers`` layers
    (the only cut), at the ``train`` phase's tokens, ``train_batch`` x
    ``train_seq`` in 2 microbatches, float32."""

    arch: str = "granite-moe-3b-a800m"
    batch: int = 4
    prompt: int = 2048
    tokens: int = 16
    seed: int = 0
    atol: float = 0.3
    rtol: float = 0.05
    train_layers: int = 2
    train_batch: int = 8
    train_seq: int = 512
    lr: float = 1e-3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def nvcc_version() -> str:
    from repro_torch.kernels import _build
    out = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[-1]


# -- timing -------------------------------------------------------------------

class Timer:
    """Median time of a call on the card: CUDA events around each launch,
    with a 256 MB write before each so the 50 MB L2 holds nothing of the
    inputs (the real caller has just uploaded or produced them, but other
    work runs in between)."""

    def __init__(self, torch, reps: int):
        self.torch = torch
        self.reps = reps
        self.flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")

    def ms(self, fn) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(self.reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound(nbytes: int, ops: int, ops_per_s: float = SCALAR_OPS_PER_S
          ) -> dict:
    """The least time the card could take: the larger of moving ``nbytes``
    (each input read once, each output written once) and doing ``ops`` at
    ``ops_per_s``."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


# -- phase 1: build -------------------------------------------------------------

def phase_build(torch) -> dict:
    from repro_torch.kernels import _build
    libs = _build.build()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "smem" in ln or "spill" in ln]
             for name, log in _build.BUILD_LOG.items()}
    return {"libraries": {k: str(v.relative_to(ROOT)) for k, v in
                          libs.items()},
            "ptxas": ptxas, "card": nvidia_smi_line(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "nvcc": nvcc_version()}


# -- phase 2: kernels against their plain versions ------------------------------

def _table(rng, cfg: Config):
    """A 3000-entry override table padded to the 4096-slot capacity, as
    ``Assignment.table_arrays`` lays it out (entries first, then -1)."""
    tk = np.full(cfg.table_capacity, -1, np.int32)
    td = np.zeros(cfg.table_capacity, np.int32)
    tk[:cfg.table_max] = rng.choice(cfg.k, size=cfg.table_max, replace=False)
    td[:cfg.table_max] = rng.integers(0, cfg.n_tasks, size=cfg.table_max)
    return tk, td


def _stats_path_input(keys: np.ndarray, cfg: Config):
    """What the stats path hands the kernel for one WordCount interval: one
    entry per (dest, key) group in (dest, key) order, weighted by its tuple
    count (float64, as the stats path's weights are)."""
    from repro_torch.core import Hash32
    uniq, counts = np.unique(keys, return_counts=True)
    dest = Hash32(cfg.n_tasks, cfg.seed)(uniq)
    order = np.lexsort((uniq, dest))
    return uniq[order].astype(np.int32), counts[order].astype(np.float64)


def stream_kernel_inputs(cfg: Config) -> dict:
    """The stream kernels' inputs at the main path's shapes, as numpy arrays:
    the routing table, the dense domain's keys and one interval's 4M zipf
    tuples; the zipf tuples' costs and the stats path's (dest, key) groups
    with their weights."""
    from repro_torch.streams import WorkloadGen
    rng = np.random.default_rng(cfg.seed + 1)
    gen = WorkloadGen(k=cfg.k, z=cfg.z, f=cfg.f, seed=cfg.seed + 1,
                      window=cfg.window)
    keys4m = gen.draw_tuples(cfg.tuples).astype(np.int32)
    tk, td = _table(rng, cfg)
    domain = 1 << (cfg.k - 1).bit_length()
    stats_keys, stats_counts = _stats_path_input(keys4m.astype(np.int64), cfg)
    return {"table": (tk, td), "domain": domain,
            "routing_lookup[dense]": np.arange(domain + 1, dtype=np.int32),
            "routing_lookup[per_tuple]": keys4m,
            "key_stats[zipf_tuples]": (
                keys4m, rng.uniform(0.5, 1.5, size=keys4m.size)
                .astype(np.float32), domain),
            "key_stats[stats_path]": (
                stats_keys, stats_counts, int(stats_keys.max()) + 1),
            # the stats path's two weights: per-group cost and count
            "stats_path_weights": (
                stats_counts * rng.uniform(0.5, 1.5, size=stats_counts.size),
                stats_counts)}


def reorder_bound(torch, freq, pcost):
    """How far a float32 sum of g(k) terms in another order may lie from
    the plain version's (non-negative terms): each is within (g(k) - 1)
    2^-24 sum|terms| of the exact sum."""
    return 2.0 * freq * 2.0**-24 * pcost.abs() + 1e-30


def check_edge_cases(torch, dev) -> float:
    """The wrappers' contracts on the card; returns the largest error."""
    from repro_torch.core import Hash32
    from repro_torch.kernels import (RoutingTable, key_stats, key_stats_plain,
                                     route_keys, route_plain, routing_lookup)
    from repro_torch.core.balancer import fmix32

    def i32(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int32)).to(dev)

    err = 0.0
    probe = np.arange(4096, dtype=np.int64)
    high = probe[fmix32(probe.astype(np.uint32), 5) >= 2**31][:64]
    edge = np.concatenate([[0, 1, 2**31 - 2, 2**31 - 1], high])
    rng = np.random.default_rng(3)
    for a in (1, 128, 4096, 16384):    # 16384 slots: the largest table
        tk = np.full(a, -1, np.int64)
        td = np.zeros(a, np.int64)
        tk[0], td[0] = 2**31 - 1, 11
        table = RoutingTable(i32(tk), i32(td))
        got = route_keys(i32(edge), table, 13, seed=5).cpu().numpy()
        want = Hash32(13, 5)(edge)
        want[3] = 11
        err = max(err, float(np.abs(got - want).max()))
        # a full table, empty slots with other dests, the negative keys, and
        # key arrays that start off the 16-byte grid
        tk = np.full(a, -1, np.int64)
        td = rng.integers(0, 13, size=a)
        real = rng.choice(2**31 - 1, size=max(0, a - 3), replace=False)
        tk[:real.size] = real
        tk, td = tk[rng.permutation(a)], td
        table = RoutingTable.from_arrays(tk, td, dev)
        keys = np.concatenate([rng.choice(real, size=min(real.size, 500))
                               if real.size else [], edge,
                               [-1, -2, -(2**31), 2**31 - 1, -1]])
        keys = i32(rng.permutation(keys))
        for off in range(4):
            got = route_keys(keys[off:], table, 13, seed=5)
            want = route_plain(keys[off:], table, 13, seed=5)
            err = max(err, float((got - want).abs().max()))
    if route_keys(i32([]), table, 13).numel() != 0:
        raise AssertionError("routing an empty key batch returned keys")
    for tk, td in (([4, -1, 4], [1, 0, 2]), ([4, -1], [1, -1])):
        try:
            routing_lookup(i32([4]), i32(tk), i32(td), 10)
        except ValueError:
            pass
        else:
            raise AssertionError(f"table {tk} -> {td} was not refused")
    for bad in (torch.int64, torch.float32):
        for call in (lambda: route_keys(i32([1]).to(bad), table, 13),
                     lambda: key_stats(i32([1]).to(bad),
                                       torch.ones(1, device=dev), 4)):
            try:
                call()
            except TypeError:
                pass
            else:
                raise AssertionError(f"{bad} keys were not refused")
    keys = i32([0, 1, -1, 1, -1, 4, 2**31 - 1, 3, 2**31 - 2])
    freq, cost = key_stats(keys, torch.arange(1, 10, dtype=torch.float32,
                                              device=dev), 4)
    err = max(err, float(np.abs(freq.cpu().numpy() - [1, 2, 0, 1]).max()),
              float(np.abs(cost.cpu().numpy() - [1, 6, 0, 8]).max()))
    # one key in half the tuples, off the 16-byte grid, float64 costs
    keys = rng.zipf(1.2, size=300_001) % 5000
    keys[rng.random(keys.size) < 0.5] = 7
    keys, costs = i32(keys), torch.from_numpy(rng.uniform(
        0.5, 1.5, size=keys.size)).to(dev)
    for off in range(4):
        freq, cost = key_stats(keys[off:], costs[off:], 5000)
        pfreq, pcost = key_stats_plain(keys[off:], costs[off:], 5000)
        err = max(err, float((freq - pfreq).abs().max()))
        if bool(((cost - pcost).abs() > reorder_bound(torch, pfreq,
                                                     pcost)).any()):
            raise AssertionError("key_stats on a hot key: c(k) off beyond "
                                 "float32 reordering")
    return err


def routing_row(timer: Timer, name: str, keys, table, cfg: Config,
                edge_err: float = 0.0) -> dict:
    """The routing kernel on ``keys`` against its plain version: the row of
    the ``kernels`` line (launches are added by ``main``)."""
    from repro_torch.kernels import route_keys, route_plain
    got = route_keys(keys, table, cfg.n_tasks, seed=cfg.seed)
    want = route_plain(keys, table, cfg.n_tasks, seed=cfg.seed)
    err = float((got - want).abs().max())
    if err != 0:
        raise AssertionError(f"{name}: kernel and plain routing differ")
    n = keys.numel()
    ms = timer.ms(lambda: route_keys(keys, table, cfg.n_tasks, seed=cfg.seed))
    lower = bound(8 * n + 8 * len(table), n * ROUTE_OPS_PER_KEY)
    return {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/csrc/routing_lookup.cu",
        "replaces": "src/repro/kernels/routing_lookup.py:54",
        "shape": {"n": n, "table_slots": len(table),
                  "table_buckets": int(table.buckets.shape[0]),
                  "max_probe": table.max_probe},
        "max_abs_err": max(err, edge_err), "ms": ms,
        "plain_ms": timer.ms(lambda: route_plain(keys, table, cfg.n_tasks,
                                                 seed=cfg.seed)),
        **lower, "bound_share": lower["bound_ms"] / ms, "library_ms": None}


def phase_kernels(torch, cfg: Config, timer: Timer, dev):
    """Each kernel against its plain version, at the main path's shapes."""
    from repro_torch.kernels import RoutingTable, key_stats, key_stats_plain
    from repro_torch.kernels.key_stats import key_sums
    inputs = stream_kernel_inputs(cfg)
    table = RoutingTable.from_arrays(*inputs["table"], dev)
    edge_err = check_edge_cases(torch, dev)
    if edge_err != 0:
        raise AssertionError(f"edge cases: kernel off by {edge_err}")

    rows = [routing_row(timer, name, torch.from_numpy(inputs[name]).to(dev),
                        table, cfg, edge_err)
            for name in ("routing_lookup[dense]",
                         "routing_lookup[per_tuple]")]

    for name in ("key_stats[zipf_tuples]", "key_stats[stats_path]"):
        keys_np, costs_np, num = inputs[name]
        keys = torch.from_numpy(keys_np).to(dev)
        costs = torch.from_numpy(costs_np).to(dev)
        freq, cost = key_stats(keys, costs, num)
        pfreq, pcost = key_stats_plain(keys, costs, num)
        if not torch.equal(freq, pfreq):
            raise AssertionError(f"{name}: kernel and plain g(k) differ")
        cerr = (cost - pcost).abs()
        if bool((cerr > reorder_bound(torch, freq, pcost)).any()):
            raise AssertionError(f"{name}: kernel and plain c(k) differ "
                                 "beyond float32 reordering")
        valid = (keys >= 0) & (keys < num)
        mk = keys[valid]
        mc = costs[valid].to(torch.float32)
        n = keys.numel()
        ms = timer.ms(lambda: key_stats(keys, costs, num))
        lower = bound(n * (4 + costs.element_size()) + 8 * num,
                      STATS_OPS_PER_TUPLE * n)
        row = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/key_stats.cu",
            "replaces": "src/repro/kernels/key_stats.py:31",
            "shape": {"n": n, "num_keys": num,
                      "cost_dtype": str(costs.dtype).split(".")[-1]},
            "max_abs_err": max(float(cerr.max()), edge_err), "ms": ms,
            "plain_ms": timer.ms(lambda: key_stats_plain(keys, costs, num)),
            **lower, "bound_share": lower["bound_ms"] / ms,
            "library_ms": timer.ms(lambda: (
                torch.bincount(mk, minlength=num),
                torch.bincount(mk, weights=mc, minlength=num)))}
        if name == "key_stats[stats_path]":
            # what the stats path launches: both weights in one pass,
            # against two plain calls
            w1, w2 = (torch.from_numpy(w).to(dev)
                      for w in inputs["stats_path_weights"])
            s1, s2 = key_sums(keys, w1, w2, num)
            p1 = key_stats_plain(keys, w1, num)[1]
            p2 = key_stats_plain(keys, w2, num)[1]
            # each key appears once in the stats path's groups: the sums
            # are single float32 casts, equal in any order
            werr = max(float((s1 - p1).abs().max()),
                       float((s2 - p2).abs().max()))
            if werr != 0:
                raise AssertionError(f"two-weight stats launch off its plain "
                                     f"calls by {werr}")
            row["two_weight"] = {
                "max_abs_err": werr,
                "ms": timer.ms(lambda: key_sums(keys, w1, w2, num)),
                "plain_ms": timer.ms(lambda: (
                    key_stats_plain(keys, w1, num),
                    key_stats_plain(keys, w2, num)))}
        rows.append(row)
    return rows


#: the flash kernel's tolerance against its plain version, by dtype: the JAX
#: package's own (tests/test_kernels.py: 2e-5 in float32, 2e-2 in bf16)
FLASH_ATOL = {"float32": 2e-5, "bfloat16": 2e-2}


def flash_err_over_tol(torch, got, want, v) -> float:
    """The flash kernel's largest error against its plain version over the
    tolerance for a path's activations: ``FLASH_ATOL`` (set for unit-scale
    inputs) times v's rms, since each output row is a weighted mean of v's
    rows, plus one ulp of the output's dtype (<= 1 passes)."""
    want = want.float()
    tol = (FLASH_ATOL[str(v.dtype).split(".")[-1]]
           * float(v.float().pow(2).mean().sqrt())
           + torch.finfo(v.dtype).eps * want.abs())
    return float(((got.float() - want).abs() / tol).max())


def admitted_pairs(t: int, s: int, causal: bool, window: int) -> int:
    """(query, key) pairs the mask admits for one head: the work the
    attention needs (queries right-aligned against the keys)."""
    q_pos = np.arange(t) + s - t
    hi = np.minimum(q_pos, s - 1) if causal else np.full(t, s - 1)
    lo = np.maximum(q_pos - window + 1, 0) if window > 0 else np.zeros(t)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def _flash_inputs(torch, shape, dtype, dev, seed: int):
    b, hq, hkv, t, s, d = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(sh, generator=g, device=dev).to(dtype)
            for sh in ((b, hq, t, d), (b, hkv, s, d), (b, hkv, s, d))]


def check_flash_edges(torch, dev) -> float:
    """The flash kernel at the edges of its contract against its plain
    version; returns the largest error relative to each case's tolerance
    (<= 1 passes)."""
    from repro_torch.kernels import flash_attention, flash_attention_plain
    worst = 0.0
    f32, bf16 = torch.float32, torch.bfloat16
    for shape, window, dtype, causal in (
            ((1, 4, 4, 1, 256, 64), 0, f32, True),         # T=1 decode
            ((1, 16, 8, 1, 256, 240), 1024, bf16, True),
            ((1, 8, 2, 17, 250, 32), 0, f32, True),        # ragged T and S
            ((1, 16, 8, 17, 250, 240), 100, bf16, True),
            ((1, 4, 1, 96, 96, 32), 0, f32, True),         # MQA
            ((2, 16, 1, 130, 130, 240), 64, bf16, True),
            ((1, 2, 1, 100, 40, 16), 0, f32, True),        # T > S: zero rows
            ((2, 8, 2, 192, 192, 64), 16, f32, True),      # f32 window
            ((2, 4, 2, 150, 170, 20), 0, bf16, True),      # D padded to 24
            ((1, 24, 8, 130, 130, 64), 0, bf16, True),     # granite-moe 3:1
            ((1, 24, 8, 130, 130, 64), 0, f32, True),
            ((1, 16, 1, 150, 150, 128), 0, bf16, True),    # granite-20b MQA
            ((1, 16, 1, 150, 150, 128), 0, f32, True),
            ((2, 8, 2, 192, 192, 64), 16, bf16, False),    # non-causal window
            ((1, 4, 2, 130, 170, 32), 50, f32, False)):
        q, k, v = _flash_inputs(torch, shape, dtype, dev, seed=sum(shape))
        got = flash_attention(q, k, v, causal=causal, window=window)
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        tol = FLASH_ATOL[str(dtype).split(".")[-1]]
        worst = max(worst, float((got.float() - want.float()).abs().max())
                    / tol)
    return worst


def phase_flash(torch, scfg: ServeConfig, mcfg: "MoeServeConfig",
                timer: Timer, dev) -> list:
    """The flash kernel at the serve paths' shapes, one row per model and
    masking mode (gemma3-12b's window and global layers, granite-moe's
    global layer at D = 64): against its plain version, with its time, the
    plain version's and SDPA's (the one PyTorch call that computes the same
    function; the port never calls it)."""
    from repro_torch.configs import get_config
    edge = check_flash_edges(torch, dev)
    if edge > 1:
        raise AssertionError(f"flash edge cases: {edge:.3g} x tolerance")
    gemma, granite = get_config(scfg.arch), get_config(mcfg.arch)
    cases = [(f"flash_attention[window={w}]" if w
              else "flash_attention[global]", gemma, scfg, w)
             for w in sorted(set(gemma.window_pattern), reverse=True)]
    cases.append((f"flash_attention[global,D={granite.hd}]", granite, mcfg,
                  0))
    return [flash_row(torch, timer, name, cfg, sc.batch, sc.prompt, window,
                      sc.seed, dev, edge)
            for name, cfg, sc, window in cases]


def flash_row(torch, timer: Timer, name: str, cfg, b: int, t: int,
              window: int, seed: int, dev, edge: float,
              qkv: tuple = None) -> dict:
    """The flash kernel at ``cfg``'s heads on a (b, t) causal prompt against
    its plain version: the row of the ``kernels`` line, with the kernel's,
    the plain version's and SDPA's times and the bound (launches are added
    by ``main``). The inputs are random from ``seed``, or ``qkv``: the
    tensors a path handed the kernel."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention, flash_attention_plain
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = t
    q, k, v = qkv or _flash_inputs(torch, (b, hq, hkv, t, s, d),
                                   torch.bfloat16, dev, seed)
    got = flash_attention(q, k, v, causal=True, window=window)
    want = flash_attention_plain(q, k, v, causal=True, window=window)
    err = float((got.float() - want.float()).abs().max())
    # random inputs are unit-scale; a path's are held as FlashSpy holds them
    over = (err / FLASH_ATOL["bfloat16"] if qkv is None
            else flash_err_over_tol(torch, got, want, v))
    if over > 1:
        raise AssertionError(f"{name}: kernel off its plain version by "
                             f"{err} ({over} of its tolerance)")
    if window:
        pos = torch.arange(t, device=dev)
        mask = (pos[None] <= pos[:, None]) & \
            (pos[None] > pos[:, None] - window)
        sdpa_kw = {"attn_mask": mask}
    else:                          # T == S: top-left causal is right-aligned
        sdpa_kw = {"is_causal": True}

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True,
                                              **sdpa_kw)

    lib_err = float((sdpa().float() - want.float()).abs().max())
    pairs = admitted_pairs(t, s, True, window)
    nbytes = 2 * (q.numel() + k.numel() + v.numel() + got.numel())
    flops = 4 * d * pairs * b * hq
    kernel_ms = timer.ms(lambda: flash_attention(q, k, v, causal=True,
                                                 window=window))
    lower = bound(nbytes, flops, BF16_FLOPS_PER_S)
    return {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:31",
        "shape": {"b": b, "hq": hq, "hkv": hkv, "t": t, "s": s, "d": d,
                  "window": window, "dtype": "bfloat16",
                  "admitted_pairs_per_head": pairs},
        "max_abs_err": err, "edge_err_over_tol": edge,
        "library_max_abs_err": lib_err, "ms": kernel_ms,
        # the mask's work (4 D FLOPs an admitted pair) over the time, and
        # the share of the bound the kernel reaches
        "tflops": flops / kernel_ms * 1e-9,
        "bound_share": lower["bound_ms"] / kernel_ms,
        "plain_ms": timer.ms(lambda: flash_attention_plain(
            q, k, v, causal=True, window=window)),
        **lower, "library_ms": timer.ms(sdpa)}


# -- phases 3 and 4: the two configurations -------------------------------------

def make_stage(cfg: Config, backend: str, substrate: str, device,
               stats_mode: str = "exact", algorithm: str = "mixed",
               operator=None, vectorized: bool = True):
    from repro_torch import (Assignment, BalanceConfig, Hash32, KeyedStage,
                             RebalanceController, WordCount)
    controller = RebalanceController(
        Assignment(Hash32(cfg.n_tasks, seed=cfg.seed)),
        BalanceConfig(theta_max=cfg.theta_max, table_max=cfg.table_max,
                      window=cfg.window),
        algorithm=algorithm, stats_mode=stats_mode)
    return KeyedStage(operator or WordCount(), controller, window=cfg.window,
                      state_backend=backend, substrate=substrate,
                      device=device, vectorized=vectorized)


def _finite_report(r, n_tasks: int) -> None:
    vals = [getattr(r, f) for f in REPORT_FIELDS]
    if not (np.all(np.isfinite(vals)) and r.task_loads.shape == (n_tasks,)
            and np.all(np.isfinite(r.task_loads))):
        raise AssertionError(f"interval {r.interval}: malformed report")


def _same_report(got, want, exact: bool) -> None:
    if exact:
        for f in REPORT_FIELDS:
            if getattr(got, f) != getattr(want, f):
                raise AssertionError(f"interval {want.interval}: {f} "
                                     f"{getattr(got, f)} != "
                                     f"{getattr(want, f)}")
        np.testing.assert_array_equal(got.task_loads, want.task_loads)
    else:
        for f in ("interval", "tuples", "table_size", "migrated_bytes",
                  "buffered"):
            if getattr(got, f) != getattr(want, f):
                raise AssertionError(f"interval {want.interval}: {f} differs")
        np.testing.assert_allclose(got.task_loads, want.task_loads,
                                   rtol=1e-5)


def spanned(fn, times: list, sync):
    """``fn`` that appends its wall ms, between two synchronisations, to
    ``times``."""
    def wrapper(*a, **kw):
        sync()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        return out
    return wrapper


def table_digest(table: dict) -> str:
    """A short digest of a routing table, to compare tables across runs."""
    items = np.array(sorted(table.items()), dtype=np.int64)
    return hashlib.sha1(items.tobytes()).hexdigest()[:12]


def phase_stream(cfg: Config, device, sync) -> tuple:
    """The main path on ``device`` against columnar + numpy on the CPU.

    Returns (metrics, the CPU reference's per-interval record for the stats
    phase, every interval's keys for the chaos phase)."""
    from repro_torch.kernels.routing_lookup import RoutingTable
    from repro_torch.streams import WorkloadGen
    from repro_torch.streams import device as device_mod
    dev = make_stage(cfg, "device", "kernels", device)
    ref = make_stage(cfg, "columnar", "numpy", "cpu")
    gen = WorkloadGen(k=cfg.k, z=cfg.z, f=cfg.f, seed=cfg.seed,
                      window=cfg.window)
    fleet = dev.backend.fleet
    spans = {"step_ms": [], "route_ms": [], "table_build_ms": [],
             "table_upload_ms": [], "kernel_ms": []}

    def span(fn, key):
        return spanned(fn, spans[key], sync)

    fleet.interval_step = span(fleet.interval_step, "step_ms")
    fleet.route_dense = span(fleet.route_dense, "route_ms")
    # the dense route's parts: the table built on the host, its upload and
    # the kernel, each between two synchronisations (which the route's own
    # span then includes)
    build, to, route = RoutingTable.build, RoutingTable.to, \
        device_mod.route_keys
    RoutingTable.build = classmethod(span(build.__func__, "table_build_ms"))
    RoutingTable.to = span(to, "table_upload_ms")
    device_mod.route_keys = span(route, "kernel_ms")
    try:
        result = _drive_stream(cfg, dev, ref, gen, sync)
    finally:
        RoutingTable.build, RoutingTable.to = build, to
        device_mod.route_keys = route
    metrics, record, trace = result
    metrics.update({"step_ms": spans["step_ms"],
                    "route_dense_ms": spans["route_ms"],
                    "route_dense_parts_ms": {
                        k: spans[k] for k in ("table_build_ms",
                                              "table_upload_ms",
                                              "kernel_ms")}})
    return metrics, record, trace


def _drive_stream(cfg: Config, dev, ref, gen, sync) -> tuple:
    record, interval_ms, ref_ms, gen_ms, trace = [], [], [], [], []
    stats_keys, digests = [], []
    for i in range(cfg.intervals):
        t0 = time.perf_counter()
        if i:
            gen.interval(dev.controller.assignment)
        keys = gen.draw_tuples(cfg.tuples).astype(np.int64)
        gen_ms.append((time.perf_counter() - t0) * 1e3)
        trace.append(keys)
        sync()
        t0 = time.perf_counter()
        r_dev = dev.process_interval_arrays(keys)
        sync()
        interval_ms.append((time.perf_counter() - t0) * 1e3)
        stats_keys.append(int(dev.last_stats.keys.size))
        digests.append(table_digest(dev.controller.assignment.table))
        t0 = time.perf_counter()
        r_ref = ref.process_interval_arrays(keys)
        ref_ms.append((time.perf_counter() - t0) * 1e3)
        _finite_report(r_dev, cfg.n_tasks)
        _same_report(r_dev, r_ref, exact=True)
        if dev.controller.assignment.table != ref.controller.assignment.table:
            raise AssertionError(f"interval {i + 1}: routing tables differ")
        if i < cfg.stats_intervals:
            ls = ref.last_stats
            record.append((keys, r_ref, (ls.keys, ls.cost, ls.freq),
                           dict(ref.controller.assignment.table)))
    if dev.outputs != ref.outputs or dev.emitted_sum != ref.emitted_sum:
        raise AssertionError("outputs differ from the CPU reference")
    results = [ev.result for ev in dev.controller.history
               if ev.result is not None]
    plans = [r.plan_time_s * 1e3 for r in results]
    if not plans or dev.controller.assignment.table_size == 0:
        raise AssertionError("the stream never rebalanced")
    med = statistics.median(interval_ms)
    return {"intervals": cfg.intervals, "tuples_per_interval": cfg.tuples,
            "keys": cfg.k, "window": cfg.window,
            "rebalances": len(plans),
            "table_size": dev.controller.assignment.table_size,
            "interval_ms": interval_ms, "interval_ms_median": med,
            "tuples_per_s": cfg.tuples / med * 1e3,
            "plan_ms": plans, "plan_ms_median": statistics.median(plans),
            "generator_ms": gen_ms, "cpu_reference_interval_ms": ref_ms,
            "stats_keys": stats_keys, "table_digests": digests,
            "theta": [r.theta for r in dev.reports],
            "planned_theta": [r.theta for r in results],
            "migrated_bytes": [r.migrated_bytes for r in dev.reports],
            "reports_match_cpu": True}, record, trace


def phase_stats(cfg: Config, device, sync, record) -> dict:
    """The stats path on ``device`` against the stream's CPU reference."""
    st = make_stage(cfg, "columnar", "kernels", device)
    interval_ms = []
    for keys, want, (skeys, scost, sfreq), table in record:
        sync()
        t0 = time.perf_counter()
        got = st.process_interval_arrays(keys)
        sync()
        interval_ms.append((time.perf_counter() - t0) * 1e3)
        _finite_report(got, cfg.n_tasks)
        _same_report(got, want, exact=False)
        np.testing.assert_array_equal(st.last_stats.keys, skeys)
        np.testing.assert_array_equal(st.last_stats.freq, sfreq)
        np.testing.assert_allclose(st.last_stats.cost, scost, rtol=1e-6)
        if st.controller.assignment.table != table:
            raise AssertionError("stats path planned another table")
    return {"intervals": len(record), "interval_ms": interval_ms,
            "interval_ms_median": statistics.median(interval_ms),
            "stats_match_cpu": True}


#: the stream_sketch phase's planners, each with its interval count
SKETCH_PLANNERS = (("mixed", 8), ("mintable", 2), ("minmig", 2),
                   ("compact_mixed", 2))
#: the CPU oracle of the stream_sketch phase: (state backend, substrate).
#: The device backend folds each interval into the sketch once, the
#: columnar backend twice (traffic, then held sizes); at this deployment
#: both give the same reports and tables over Mixed's 8 intervals on the
#: CPU, so the card is held against the columnar stage, as in ``stream``
SKETCH_ORACLE = ("columnar", "numpy")


def phase_stream_sketch(cfg: Config, device, sync, exact: dict) -> tuple:
    """The stream deployment in sketch mode on ``device``: the stream
    phase's stage with ``RebalanceController(stats_mode="sketch")`` and the
    default ``SketchConfig`` (width 2^16, depth 2, capacity 16384, the cost
    channel), under each planner of ``SKETCH_PLANNERS`` for its interval
    count, the generator seeded as the stream phase's. Each interval is
    held against the same planner's sketch-mode stage of ``SKETCH_ORACLE``
    on the CPU: identical reports and routing tables, then identical
    outputs, ``emitted_sum`` and held keys. Readj,
    Simple, ``mixed_bf`` and the scalar reference planners plan in Python
    loops over keys (Readj in O(rounds * H^2), ``mixed_bf`` in N_A + 1 LLFD
    trials): at this size they time the host, not the port, so only the
    CPU tests hold them against the JAX package.

    ``exact`` is the stream phase's result: its per-interval stats keys,
    plan and interval ms and planned θ are reported beside the sketch
    run's, and Mixed's routing tables are compared with its tables
    (``tables_as_exact``, a reading, not a check). Returns (metrics, Mixed's
    last routing table and dense domain, for the kernel's row)."""
    from repro_torch.kernels import key_stats, route_keys
    out = {"oracle": "+".join(SKETCH_ORACLE),
           "exact_stats_keys": exact["stats_keys"],
           "exact_plan_ms": exact["plan_ms"],
           "exact_interval_ms": exact["interval_ms"],
           "exact_planned_theta": exact["planned_theta"]}
    route_input = None
    for algorithm, intervals in SKETCH_PLANNERS:
        route_keys.launches = 0
        key_stats.launches = 0
        run, dev = _drive_sketch(cfg, algorithm, intervals, device, sync)
        run["launches"] = {"route_keys": route_keys.launches,
                           "key_stats": key_stats.launches}
        if algorithm == "mixed":
            # intervals whose plan gave the exact phase's routing table
            run["tables_as_exact"] = [
                a == b for a, b in zip(run.pop("table_digests"),
                                       exact["table_digests"])]
        else:
            del run["table_digests"]
        if route_input is None:
            # padded as the stage pads the table it routes with next
            table = dev.controller.assignment
            pad = max(dev._table_capacity,
                      128, 1 << max(0, table.table_size - 1).bit_length())
            route_input = (*table.table_arrays(pad),
                           dev.backend.fleet.domain)
        out[algorithm] = run
    return out, route_input


def _drive_sketch(cfg: Config, algorithm: str, intervals: int, device,
                  sync) -> tuple:
    """One planner's sketch-mode run against the CPU oracle; returns
    (metrics, the device stage)."""
    from repro_torch.streams import WorkloadGen
    dev = make_stage(cfg, "device", "kernels", device, "sketch", algorithm)
    ref = make_stage(cfg, *SKETCH_ORACLE, "cpu", "sketch", algorithm)
    gen = WorkloadGen(k=cfg.k, z=cfg.z, f=cfg.f, seed=cfg.seed,
                      window=cfg.window)
    ctrl = dev.controller
    ingest_spans, sketch_bytes = [], [0]
    ingest = ctrl.ingest

    def timed_ingest(*a, **kw):
        t0 = time.perf_counter()
        ingest(*a, **kw)
        ingest_spans.append((time.perf_counter() - t0) * 1e3)
        sketch_bytes[0] = max(sketch_bytes[0], ctrl.sketch.nbytes)

    ctrl.ingest = timed_ingest
    fleet = dev.backend.fleet
    step_ms, route_ms = [], []
    fleet.interval_step = spanned(fleet.interval_step, step_ms, sync)
    fleet.route_dense = spanned(fleet.route_dense, route_ms, sync)
    interval_ms, ingest_ms, head_keys, versions = [], [], [], []
    digests = []
    for i in range(intervals):
        if i:
            gen.interval(ctrl.assignment)
        keys = gen.draw_tuples(cfg.tuples).astype(np.int64)
        versions.append(ctrl.assignment_version)
        n_spans = len(ingest_spans)
        sync()
        t0 = time.perf_counter()
        r_dev = dev.process_interval_arrays(keys)
        sync()
        interval_ms.append((time.perf_counter() - t0) * 1e3)
        ingest_ms.append(sum(ingest_spans[n_spans:]))
        head_keys.append(int(dev.last_stats.keys.size))
        digests.append(table_digest(ctrl.assignment.table))
        r_ref = ref.process_interval_arrays(keys)
        _finite_report(r_dev, cfg.n_tasks)
        _same_report(r_dev, r_ref, exact=True)
        if ctrl.assignment.table != ref.controller.assignment.table:
            raise AssertionError(f"{algorithm}, interval {i + 1}: routing "
                                 "tables differ")
        base = dev.last_stats.base_loads
        if base is None or not np.all(np.isfinite(base)):
            raise AssertionError(f"{algorithm}: no finite tail base loads")
    if (dev.outputs != ref.outputs or dev.emitted_sum != ref.emitted_sum
            or dev.total_state_keys() != ref.total_state_keys()):
        raise AssertionError(f"{algorithm}: outputs differ from the CPU "
                             "oracle")
    if ctrl.triggered_intervals() != ref.controller.triggered_intervals():
        raise AssertionError(f"{algorithm}: triggers differ")
    results = [ev.result for ev in ctrl.history if ev.result is not None]
    plans = [r.plan_time_s * 1e3 for r in results]
    if not plans or ctrl.assignment.table_size == 0:
        raise AssertionError(f"{algorithm}: the stream never rebalanced")
    med = statistics.median(interval_ms)
    return {"intervals": intervals, "rebalances": len(plans),
            "table_size": ctrl.assignment.table_size,
            "interval_ms": interval_ms, "interval_ms_median": med,
            "tuples_per_s": cfg.tuples / med * 1e3,
            "plan_ms": plans, "plan_ms_median": statistics.median(plans),
            "ingest_ms": ingest_ms, "step_ms": step_ms,
            "route_dense_ms": route_ms, "head_keys": head_keys,
            "sketch_bytes": sketch_bytes[0],
            "theta": [r.theta for r in dev.reports],
            "planned_theta": [r.theta for r in results],
            "table_digests": digests,
            "versions_routed": sorted(set(versions)),
            "reports_match_cpu": True}, dev


# -- the router-merge topology ---------------------------------------------------

#: the topology phase's intervals: a checkpoint after ``TOPO_CHECKPOINT_AFTER``
#: of ``TOPO_INTERVALS``, then a restore and a replay of the rest
TOPO_INTERVALS = 4
TOPO_CHECKPOINT_AFTER = 2


def make_topology(cfg: Config, device, substrate: str, state_backend: str):
    """The PKG papers' two-step word count at the stream cell's deployment:
    PartialWordCount under PKG, then WordCount under Mixed (seeded
    ``cfg.seed + 1``)."""
    from repro_torch import (Hash32, PartialWordCount, WordCount,
                             router_merge_topology)
    return router_merge_topology(
        PartialWordCount(), WordCount(), cfg.n_tasks, cfg.theta_max,
        algorithm="pkg", merge_algorithm="mixed", hash_cls=Hash32,
        substrate=substrate, state_backend=state_backend,
        window=cfg.window, table_max=cfg.table_max, seed=cfg.seed,
        device=device)


def stage_pack_bytes(ckpt) -> int:
    """Host bytes of a stage checkpoint's packs (their arrays)."""
    return int(sum(a.nbytes for p in ckpt.packs
                   for a in (p.keys, p.vals, p.sizes, p.present, p.col_iv)))


def pack_bytes(ckpt) -> int:
    """Host bytes of a topology checkpoint's packs."""
    return sum(stage_pack_bytes(st) for st in ckpt.stages)


def _same_topology_report(got, want) -> None:
    """Hold a topology report: the merge stage exactly, the split stage's
    integer fields exactly and its loads and θ within 1e-6 relative (its
    step-1 stats are float32 on the card)."""
    if (got.tuples_in, got.stage_tuples, got.buffered) != \
            (want.tuples_in, want.stage_tuples, want.buffered):
        raise AssertionError(f"interval {want.interval}: tuple counts "
                             "differ")
    (gs, gm), (ws, wm) = got.stage_reports, want.stage_reports
    _same_report(gm, wm, exact=True)
    for f in ("interval", "tuples", "table_size", "migrated_bytes",
              "buffered"):
        if getattr(gs, f) != getattr(ws, f):
            raise AssertionError(f"split, interval {ws.interval}: {f} "
                                 "differs")
    np.testing.assert_allclose(gs.task_loads, ws.task_loads, rtol=1e-6)
    np.testing.assert_allclose(gs.theta, ws.theta, rtol=1e-6)


def phase_topology(cfg: Config, device, sync) -> tuple:
    """``router_merge_topology`` on ``device``: the split stage (PKG over the
    columnar store, step-1 stats through ``key_stats``) feeding the merge
    stage (Mixed over the device ring, the dense route through the routing
    kernel), both chosen by ``state_backend="auto"``. Held against the same
    topology on the CPU (columnar, numpy) and, for exactness, against a
    single-stage WordCount under Mixed on the same keys; checkpointed after
    ``TOPO_CHECKPOINT_AFTER`` intervals, restored after the last and the
    rest replayed. Returns (metrics, per-stage launches, the merge stage's
    last table and dense domain, one split interval's stats input)."""
    from repro_torch.kernels import RoutingTable, key_stats, route_keys
    from repro_torch.streams import WorkloadGen
    from repro_torch.streams import backends as backends_mod
    from repro_torch.streams import device as device_mod
    topo = make_topology(cfg, device, "kernels", "auto")
    split, merge = topo["split"], topo["merge"]
    # on a card; on the CPU (a rehearsal) auto keeps both on the columnar
    # store
    want = ("columnar",
            "device" if merge.device.type == "cuda" else "columnar")
    if (split.state_backend, merge.state_backend) != want:
        raise AssertionError(f"auto chose {split.state_backend} and "
                             f"{merge.state_backend}, not {want}")
    oracle = make_topology(cfg, "cpu", "numpy", "columnar")
    gens = [WorkloadGen(k=cfg.k, z=cfg.z, f=cfg.f, seed=cfg.seed,
                        window=cfg.window) for _ in range(2)]
    spans = {k: [] for k in ("split_ms", "merge_ms", "route_ms",
                             "table_build_ms", "table_upload_ms",
                             "kernel_ms", "pkg_route_ms")}
    launches = {"split": {"route_keys": 0, "key_stats": 0},
                "merge": {"route_keys": 0, "key_stats": 0}}
    stats_input = []

    def counted(stage, name):
        run = stage.process_interval_emits

        def wrapper(*a, **kw):
            r0, s0 = route_keys.launches, key_stats.launches
            out = spanned(run, spans[f"{name}_ms"], sync)(*a, **kw)
            launches[name]["route_keys"] += route_keys.launches - r0
            launches[name]["key_stats"] += key_stats.launches - s0
            return out
        stage.process_interval_emits = wrapper

    def recording_key_sums(keys, w1, w2, num):
        stats_input[:] = [keys, w1, w2, num]
        return key_sums(keys, w1, w2, num)

    counted(split, "split")
    counted(merge, "merge")
    split._dest_batch = spanned(split._dest_batch, spans["pkg_route_ms"],
                                sync)
    # the merge stage's dense route and its parts, patched where the fleet
    # (rebuilt on restore) looks them up
    route_dense = device_mod.DeviceStateFleet.route_dense
    build, to, route = RoutingTable.build, RoutingTable.to, \
        device_mod.route_keys
    key_sums = backends_mod.key_sums
    device_mod.DeviceStateFleet.route_dense = spanned(
        route_dense, spans["route_ms"], sync)
    RoutingTable.build = classmethod(spanned(build.__func__,
                                             spans["table_build_ms"], sync))
    RoutingTable.to = spanned(to, spans["table_upload_ms"], sync)
    device_mod.route_keys = spanned(route, spans["kernel_ms"], sync)
    backends_mod.key_sums = recording_key_sums
    try:
        metrics, keys_by_iv, first_outputs = _drive_topology(
            cfg, topo, oracle, gens, sync)
    finally:
        device_mod.DeviceStateFleet.route_dense = route_dense
        RoutingTable.build, RoutingTable.to = build, to
        device_mod.route_keys = route
        backends_mod.key_sums = key_sums
    # the exactness witness: a single-stage WordCount under Mixed on the
    # same keys (the device ring with the plain route: no kernel launch)
    witness = make_stage(cfg, "device", "numpy", merge.device)
    for keys in keys_by_iv:
        witness.process_interval_arrays(keys)
    if first_outputs[:2] != (witness.outputs, witness.emitted_sum):
        raise AssertionError("the merge stage's counts are not the "
                             "single-stage WordCount's")
    metrics.update({
        "split_wall_ms": spans["split_ms"],
        "pkg_route_ms": spans["pkg_route_ms"],
        "merge_wall_ms": spans["merge_ms"],
        "route_dense_ms": spans["route_ms"],
        "route_dense_parts_ms": {k: spans[k] for k in (
            "table_build_ms", "table_upload_ms", "kernel_ms")},
        "merge_matches_single_stage": True})
    table = merge.controller.assignment
    pad = max(merge._table_capacity, 128,
              1 << max(0, table.table_size - 1).bit_length())
    domain = getattr(merge.backend, "fleet", None)
    route_input = (*table.table_arrays(pad),
                   domain.domain if domain is not None else 0)
    return metrics, launches, route_input, stats_input


def _drive_topology(cfg: Config, topo, oracle, gens, sync) -> tuple:
    """Checks 1, 3 and 4 of the phase; returns (metrics, each interval's
    keys, the merge stage's outputs, emitted sum and table after them)."""
    merge, split = topo["merge"], topo["split"]
    wall_ms, keys_by_iv, first, versions = [], [], [], []

    def run(keys):
        versions.append((len(wall_ms) >= TOPO_INTERVALS,
                         merge.controller.assignment_version))
        sync()
        t0 = time.perf_counter()
        rep = topo.process_interval(keys)
        sync()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        return rep

    ckpt = None
    checkpoint_ms = restore_ms = 0.0
    for i in range(TOPO_INTERVALS):
        drawn = []
        for gen, t in zip(gens, (topo, oracle)):
            if i:
                gen.interval(t["merge"].controller.assignment)
            drawn.append(gen.draw_tuples(cfg.tuples).astype(np.int64))
        if not np.array_equal(drawn[0], drawn[1]):
            raise AssertionError(f"interval {i + 1}: the card and its "
                                 "oracle drew different keys")
        keys = drawn[0]
        keys_by_iv.append(keys)
        rep = run(keys)
        want = oracle.process_interval(keys)
        for r in rep.stage_reports:
            _finite_report(r, cfg.n_tasks)
        _same_topology_report(rep, want)
        if merge.controller.assignment.table != \
                oracle["merge"].controller.assignment.table:
            raise AssertionError(f"interval {i + 1}: merge tables differ")
        first.append(rep)
        if i + 1 == TOPO_CHECKPOINT_AFTER:
            sync()
            t0 = time.perf_counter()
            ckpt = topo.checkpoint()
            sync()
            checkpoint_ms = (time.perf_counter() - t0) * 1e3
    for stage, want in ((merge, oracle["merge"]), (split, oracle["split"])):
        if (stage.outputs != want.outputs
                or stage.emitted_sum != want.emitted_sum):
            raise AssertionError("outputs differ from the CPU oracle")
    # routers never plan
    for r in split.reports:
        if r.migrated_bytes or r.table_size or r.buffered:
            raise AssertionError(f"split, interval {r.interval}: the router "
                                 "planned")
    if split.controller.triggered_intervals():
        raise AssertionError("the split stage triggered")
    first_outputs = (dict(merge.outputs), merge.emitted_sum,
                     dict(merge.controller.assignment.table))
    plans = [ev.result.plan_time_s * 1e3 for ev in merge.controller.history
             if ev.result is not None]
    sync()
    t0 = time.perf_counter()
    topo.restore(ckpt)
    sync()
    restore_ms = (time.perf_counter() - t0) * 1e3
    for i in range(TOPO_CHECKPOINT_AFTER, TOPO_INTERVALS):
        rep = run(keys_by_iv[i])
        _same_topology_report(rep, first[i])
    if (dict(merge.outputs), merge.emitted_sum,
            dict(merge.controller.assignment.table)) != first_outputs:
        raise AssertionError("the replay after restore differs")
    pass_ms = wall_ms[:TOPO_INTERVALS]
    return {
        "intervals": TOPO_INTERVALS, "replayed": TOPO_INTERVALS
        - TOPO_CHECKPOINT_AFTER, "tuples_per_interval": cfg.tuples,
        "keys": cfg.k, "window": cfg.window,
        "backends": {"split": split.state_backend,
                     "merge": merge.state_backend},
        "topology_wall_ms": wall_ms,
        "tuples_per_s": [cfg.tuples / ms * 1e3 for ms in wall_ms],
        "tuples_per_s_median": cfg.tuples / statistics.median(pass_ms) * 1e3,
        "throughput_model": [r.throughput for r in first],
        "split_theta": [r.stage_reports[0].theta for r in first],
        "split_task_loads": [r.stage_reports[0].task_loads.tolist()
                             for r in first],
        "merge_theta": [r.stage_reports[1].theta for r in first],
        "merge_table_size": [r.stage_reports[1].table_size for r in first],
        "merge_plan_ms": plans,
        "checkpoint_ms": checkpoint_ms, "restore_ms": restore_ms,
        "checkpoint_host_bytes": pack_bytes(ckpt),
        "checkpoint_keys": [sum(int(p.keys.size) for p in st.packs)
                            for st in ckpt.stages],
        "versions_routed": sorted(set(versions)),
        "reports_match_cpu": True, "replay_matches": True}, \
        keys_by_iv, first_outputs


def check_topology_launches(metrics: dict, launches: dict) -> None:
    """Check 5 of the phase: ``key_stats`` once per split-stage interval,
    the routing kernel at least once per assignment version the merge stage
    routed with, and neither stage launching the other's kernel."""
    split_intervals = len(metrics["split_wall_ms"])
    if launches["split"]["route_keys"] or launches["merge"]["key_stats"]:
        raise AssertionError(f"a stage launched another stage's kernel: "
                             f"{launches}")
    if launches["split"]["key_stats"] != split_intervals:
        raise AssertionError(
            f"key_stats launched {launches['split']['key_stats']} times in "
            f"{split_intervals} split-stage intervals")
    versions = len(metrics["versions_routed"])
    if not 0 < versions <= launches["merge"]["route_keys"]:
        raise AssertionError(
            f"{launches['merge']['route_keys']} routing launches for "
            f"{versions} assignment versions")


def topology_stats_row(timer: Timer, stats_input,
                       name: str = "key_stats[topology_split]") -> dict:
    """``key_stats`` on one host-store stage's stats input (one interval's
    per-group keys, costs and counts), the two-weight launch that stage
    makes, against two plain calls."""
    import torch
    from repro_torch.kernels import key_stats_plain
    from repro_torch.kernels.key_stats import key_sums
    keys, w1, w2, num = stats_input
    s1, s2 = key_sums(keys, w1, w2, num)
    pfreq, p1 = key_stats_plain(keys, w1, num)
    p2 = key_stats_plain(keys, w2, num)[1]
    err = 0.0
    for got, want in ((s1, p1), (s2, p2)):
        diff = (got - want).abs()
        if bool((diff > reorder_bound(torch, pfreq, want)).any()):
            raise AssertionError(f"{name}: kernel and plain sums differ "
                                 "beyond float32 reordering")
        err = max(err, float(diff.max()))
    n = keys.numel()
    valid = (keys >= 0) & (keys < num)
    mk = keys[valid]
    m1, m2 = (w[valid].to(torch.float32) for w in (w1, w2))
    ms = timer.ms(lambda: key_sums(keys, w1, w2, num))
    lower = bound(n * (4 + w1.element_size() + w2.element_size())
                  + 8 * num, STATS_OPS_PER_TUPLE * n)
    return {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/csrc/key_stats.cu",
        "replaces": "src/repro/kernels/key_stats.py:31",
        "shape": {"n": n, "num_keys": num, "weights": 2,
                  "cost_dtype": str(w1.dtype).split(".")[-1]},
        "max_abs_err": err, "ms": ms,
        "plain_ms": timer.ms(lambda: (key_stats_plain(keys, w1, num),
                                      key_stats_plain(keys, w2, num))),
        **lower, "bound_share": lower["bound_ms"] / ms,
        "library_ms": timer.ms(lambda: (
            torch.bincount(mk, weights=m1, minlength=num),
            torch.bincount(mk, weights=m2, minlength=num)))}


# -- the chaos phase: recovery, autoscaling, the object store -------------------

#: the recovery leg: intervals, the checkpoint cadence and the fault plan
CHAOS_INTERVALS = 8
CHAOS_CHECKPOINT_EVERY = 2
CHAOS_PLAN = (("kill", 3, "mid"), ("kill", 4, "deliver"), ("drop", 5),
              ("duplicate", 6), ("stall", 7, 2), ("kill", 8, "mid"))
#: what the runner records for that plan, as (interval, kind, replayed):
#: the second delivery of interval 6 is interval 7's first, which the stall
#: refuses, so the duplicate is caught as a stall (the JAX package's
#: runner gives the same list, ``tests/test_torch_faults.py``)
CHAOS_EVENTS = [(3, "kill@mid", 1), (4, "kill@deliver", 2), (5, "drop", 1),
                (6, "stall@deliver", 2), (7, "stall@deliver", 1),
                (8, "kill@mid", 2)]
#: the autoscale leg's traffic, (share of the cell's tuples an interval,
#: intervals): quiet, 4x, quiet — 1M, 4M, 1M at the cell
AUTOSCALE_TRAFFIC = ((0.25, 4), (1.0, 5), (0.25, 5))
#: the autoscale leg's fleet bounds
AUTOSCALE_TASKS = (4, 15)


@dataclasses.dataclass(frozen=True)
class ObjectLegConfig:
    """The object-store leg: WindowedSelfJoin over float tick values (the
    paper's self-join over stock ticks) at the stream cell's deployment,
    cut to K = 10^5 keys and 500K tuples an interval for 4 intervals: the
    store holds one Python ``KeyState`` a key and its oracle, the per-tuple
    loop, runs one Python call a tuple. The probe cost is dyadic (1/64, as
    the tests pin it): at the default 0.01 the per-tuple loop's running
    float64 sums and the batch closed form round differently, and the two
    stages plan different tables from the same traffic."""

    k: int = 100_000
    tuples: int = 500_000
    intervals: int = 4
    probe_cost: float = 1 / 64


def make_faults(spec):
    """A ``FaultPlan`` from ``(kind, interval, arg)`` rows."""
    from repro_torch.streams import (DropDelivery, DuplicateDelivery,
                                     FaultPlan, KillTask, StallTask)
    faults = []
    for row in spec:
        kind, iv = row[0], row[1]
        if kind == "kill":
            faults.append(KillTask(interval=iv, task=iv % 15, site=row[2]))
        elif kind == "stall":
            faults.append(StallTask(interval=iv, task=1, attempts=row[2]))
        elif kind == "drop":
            faults.append(DropDelivery(interval=iv))
        else:
            faults.append(DuplicateDelivery(interval=iv))
    return FaultPlan(faults)


def versions_seen(stage, versions: list) -> None:
    """Record the assignment version each interval of ``stage`` routes
    with (replays included)."""
    run = stage.process_interval_arrays

    def wrapper(*a, **kw):
        versions.append(stage.controller.assignment_version)
        return run(*a, **kw)
    stage.process_interval_arrays = wrapper


def instrument_runner(runner, sync) -> dict:
    """Time a ``ChaosRunner``'s cadence checkpoints (ms, host bytes) and
    its recoveries: time to recover is from the caught fault until the
    stage is back at the failed interval (restores and replays; the
    cadence checkpoint a recovery ends with is booked as a checkpoint)."""
    from repro_torch.streams import faults as faults_mod
    out = {"checkpoints": [], "recoveries": [], "restore_ms": []}
    take, recover = runner._maybe_checkpoint, runner._recover

    def timed_checkpoint(interval):
        if interval % runner.checkpoint_every:
            return take(interval)
        sync()
        t0 = time.perf_counter()
        take(interval)
        sync()
        out["checkpoints"].append({
            "interval": interval, "ms": (time.perf_counter() - t0) * 1e3,
            "host_bytes": stage_pack_bytes(runner._ckpt)})

    def timed_recover(upto, kind):
        n_ckpt, n_rest = len(out["checkpoints"]), len(out["restore_ms"])
        sync()
        t0 = time.perf_counter()
        recover(upto, kind)
        sync()
        total = (time.perf_counter() - t0) * 1e3
        ckpt_ms = sum(c["ms"] for c in out["checkpoints"][n_ckpt:])
        restores = out["restore_ms"][n_rest:]
        out["recoveries"].append({
            "interval": upto, "kind": kind,
            "replayed": runner.events[-1].replayed,
            "time_to_recover_ms": total - ckpt_ms,
            "restore_ms": sum(restores), "restores": len(restores),
            "replay_ms": total - ckpt_ms - sum(restores)})

    runner._maybe_checkpoint = timed_checkpoint
    runner._recover = timed_recover
    faults_mod.restore_stage = spanned(faults_mod.restore_stage,
                                       out["restore_ms"], sync)
    return out


def _same_stage_run(got, want, what: str) -> None:
    """Identical reports (every field, task loads included), outputs,
    emitted sum, held keys and routing table."""
    if len(got.reports) != len(want.reports):
        raise AssertionError(f"{what}: {len(got.reports)} reports, not "
                             f"{len(want.reports)}")
    for rg, rw in zip(got.reports, want.reports):
        _same_report(rg, rw, exact=True)
    if (got.outputs != want.outputs or got.emitted_sum != want.emitted_sum
            or got.total_state_keys() != want.total_state_keys()
            or got.controller.assignment.table
            != want.controller.assignment.table):
        raise AssertionError(f"{what}: outputs, held keys or tables differ")


def phase_chaos(cfg: Config, ocfg: ObjectLegConfig, device, sync,
                trace=None) -> tuple:
    """Three legs at the stream cell's deployment (see the module
    docstring): recovery under ``ChaosRunner`` on the device ring, the
    ``AutoscaleLoop`` on the device ring against the same loop on a CPU
    columnar stage, and the object store on the ``"kernels"`` substrate
    against the per-tuple loop. ``trace`` is the stream phase's keys, one
    array an interval (the recovery leg's fault-free stage is the stream
    phase's, so its generator would draw the same); None draws them here.
    Returns (metrics, launches per leg, the chaos stage's last table and
    dense domain, the object stage's last table and keys, one object
    interval's stats input)."""
    from repro_torch.kernels import key_stats, route_keys
    from repro_torch.streams import faults as faults_mod

    def counts():
        return {"route_keys": route_keys.launches,
                "key_stats": key_stats.launches}

    launches = {}
    restore = faults_mod.restore_stage
    try:
        c0 = counts()
        recovery, chaos_stage, trace = _chaos_recovery(cfg, device, sync,
                                                       trace)
        launches["recovery"] = {k: v - c0[k] for k, v in counts().items()}
    finally:
        faults_mod.restore_stage = restore
    c0 = counts()
    autoscale = _chaos_autoscale(cfg, device, sync, trace)
    launches["autoscale"] = {k: v - c0[k] for k, v in counts().items()}
    c0 = counts()
    objects, object_stage, stats_input = _chaos_object(cfg, ocfg, device,
                                                       sync)
    launches["object"] = {k: v - c0[k] for k, v in counts().items()}
    table = chaos_stage.controller.assignment
    pad = max(chaos_stage._table_capacity, 128,
              1 << max(0, table.table_size - 1).bit_length())
    dense_input = (*table.table_arrays(pad), chaos_stage.backend.fleet.domain)
    otable = object_stage.controller.assignment
    opad = max(object_stage._table_capacity, 128,
               1 << max(0, otable.table_size - 1).bit_length())
    object_input = (*otable.table_arrays(opad), objects.pop("last_keys"))
    return ({"recovery": recovery, "autoscale": autoscale,
             "object": objects}, launches, dense_input, object_input,
            stats_input)


def check_chaos_launches(metrics: dict, launches: dict) -> None:
    """The chaos phase's kernel checks: on each recovery-leg run the
    routing kernel at least once per assignment version routed (a restore
    rewinds the version and drops the dense-dest table, so the chaos run
    relaunches: at least, not equal); the autoscale leg routes through it;
    the object leg launches both kernels in every interval; the device ring
    never launches ``key_stats``."""
    rec = metrics["recovery"]
    for run in ("plain", "chaos"):
        got, versions = rec["launches"][run], rec["versions_routed"][run]
        if not 0 < len(versions) <= got:
            raise AssertionError(f"recovery leg, {run} run: {got} routing "
                                 f"launches for {len(versions)} assignment "
                                 "versions")
    if not launches["autoscale"]["route_keys"]:
        raise AssertionError("the autoscale leg never launched the routing "
                             "kernel")
    obj = metrics["object"]
    for name, per in (("route_keys", obj["route_launches"]),
                      ("key_stats", obj["stats_launches"])):
        if min(per) < 1:
            raise AssertionError(f"object leg: {name} missed an interval: "
                                 f"{per}")
    if launches["recovery"]["key_stats"] or \
            launches["autoscale"]["key_stats"]:
        raise AssertionError(f"the device ring launched key_stats: "
                             f"{launches}")


def _chaos_recovery(cfg: Config, device, sync, trace=None) -> tuple:
    """Leg 1: ``CHAOS_INTERVALS`` intervals recorded once (or ``trace``'s),
    through a fault-free device stage and then through an identical one
    under ``ChaosRunner(checkpoint_every=CHAOS_CHECKPOINT_EVERY)`` with
    ``CHAOS_PLAN``; the two runs must be identical. Returns (metrics, the
    chaos stage, the trace)."""
    from repro_torch.kernels import route_keys
    from repro_torch.streams import ChaosRunner, WorkloadGen
    plain = make_stage(cfg, "device", "kernels", device)
    recorded = list(trace or [])[:CHAOS_INTERVALS]
    gen = None if len(recorded) == CHAOS_INTERVALS else WorkloadGen(
        k=cfg.k, z=cfg.z, f=cfg.f, seed=cfg.seed, window=cfg.window)
    trace, plain_ms, versions = [], [], {"plain": [], "chaos": []}
    launches = {}
    versions_seen(plain, versions["plain"])
    r0 = route_keys.launches
    for i in range(CHAOS_INTERVALS):
        if i < len(recorded):
            keys = recorded[i]
        else:
            if i:
                gen.interval(plain.controller.assignment)
            keys = gen.draw_tuples(cfg.tuples).astype(np.int64)
        trace.append(keys)
        sync()
        t0 = time.perf_counter()
        plain.process_interval_arrays(keys)
        sync()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
    launches["plain"] = route_keys.launches - r0

    stage = make_stage(cfg, "device", "kernels", device)
    versions_seen(stage, versions["chaos"])
    r0 = route_keys.launches
    sync()
    t0 = time.perf_counter()
    runner = ChaosRunner(stage, make_faults(CHAOS_PLAN),
                         checkpoint_every=CHAOS_CHECKPOINT_EVERY)
    sync()
    baseline_ms = (time.perf_counter() - t0) * 1e3
    spans = instrument_runner(runner, sync)
    chaos_ms = []
    for keys in trace:
        sync()
        t0 = time.perf_counter()
        runner.process_interval(keys)
        sync()
        chaos_ms.append((time.perf_counter() - t0) * 1e3)
    launches["chaos"] = route_keys.launches - r0
    for r in stage.reports:
        _finite_report(r, cfg.n_tasks)
    _same_stage_run(stage, plain, "recovery leg")
    got = [(e.interval, e.kind, e.replayed) for e in runner.events]
    if got != CHAOS_EVENTS:
        raise AssertionError(f"recovery events {got}, not {CHAOS_EVENTS}")
    return {
        "intervals": CHAOS_INTERVALS, "tuples_per_interval": cfg.tuples,
        "checkpoint_every": CHAOS_CHECKPOINT_EVERY,
        "faults": [list(f) for f in CHAOS_PLAN], "events": got,
        "recoveries": spans["recoveries"],
        "time_to_recover_ms": [r["time_to_recover_ms"]
                               for r in spans["recoveries"]],
        "checkpoints": spans["checkpoints"],
        "baseline_checkpoint_ms": baseline_ms,
        "plain_interval_ms": plain_ms, "plain_wall_ms": sum(plain_ms),
        "chaos_interval_ms": chaos_ms, "chaos_wall_ms": sum(chaos_ms),
        "chaos_over_plain": sum(chaos_ms) / sum(plain_ms),
        "launches": launches,
        "versions_routed": {k: sorted(set(v)) for k, v in versions.items()},
        "table_size": stage.controller.assignment.table_size,
        "reports_match_fault_free": True}, stage, trace


def _chaos_autoscale(cfg: Config, device, sync, trace) -> dict:
    """Leg 2: ``AutoscaleLoop`` on the device ring at the full fleet,
    through ``AUTOSCALE_TRAFFIC``, against the same loop on a CPU columnar
    stage (numpy): identical decisions, reports and tables, no task
    flagged, and ``scale_to`` run both ways. Interval i takes the first
    ``share * cfg.tuples`` keys of the recovery leg's interval ``i mod 8``
    (drawing them anew costs ~4.5 s an interval of host time at K =
    10^6)."""
    from repro_torch.core import (AutoscaleConfig, AutoscaleLoop,
                                  HeartbeatMonitor)
    lo, hi = AUTOSCALE_TASKS
    config = dict(target_load=cfg.tuples / hi, min_tasks=lo, max_tasks=hi)
    dev = AutoscaleLoop(make_stage(cfg, "device", "kernels", device),
                        AutoscaleConfig(**config), monitor=HeartbeatMonitor())
    ref = AutoscaleLoop(make_stage(cfg, "columnar", "numpy", "cpu"),
                        AutoscaleConfig(**config), monitor=HeartbeatMonitor())
    scale_ms = []
    dev.stage.scale_to = spanned(dev.stage.scale_to, scale_ms, sync)
    step_ms, fleet = [], []
    i = 0
    for share, intervals in AUTOSCALE_TRAFFIC:
        tuples = int(share * cfg.tuples)
        for _ in range(intervals):
            keys = trace[i % len(trace)][:tuples]
            sync()
            t0 = time.perf_counter()
            dev.step(keys)
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            ref.step(keys)
            fleet.append(dev.stage.n_tasks)
            if dev.stage.controller.assignment.table != \
                    ref.stage.controller.assignment.table:
                raise AssertionError(f"autoscale, interval {i + 1}: routing "
                                     "tables differ")
            i += 1
    decisions = [dataclasses.astuple(d) for d in dev.decisions]
    if decisions != [dataclasses.astuple(d) for d in ref.decisions]:
        raise AssertionError("autoscale decisions differ from the CPU loop")
    for r in dev.stage.reports:
        _finite_report(r, len(r.task_loads))
    if len(dev.stage.reports) != len(ref.stage.reports):
        raise AssertionError("autoscale: report counts differ")
    for rg, rw in zip(dev.stage.reports, ref.stage.reports):
        _same_report(rg, rw, exact=True)
    if dev.stalled_tasks or ref.stalled_tasks:
        raise AssertionError(f"autoscale flagged tasks: {dev.stalled_tasks}")
    applied = {d.reason for d in dev.decisions if d.applied}
    if applied != {"scale-in", "scale-out"}:
        raise AssertionError(f"autoscale applied {applied}, not a scale-in "
                             "and a scale-out")
    return {
        "traffic": [[int(share * cfg.tuples), n]
                    for share, n in AUTOSCALE_TRAFFIC], "config": config,
        "decisions": [dataclasses.asdict(d) for d in dev.decisions],
        "fleet": fleet, "step_ms": step_ms, "scale_to_ms": scale_ms,
        "theta": [r.theta for r in dev.stage.reports],
        "migrated_bytes": [r.migrated_bytes for r in dev.stage.reports],
        "decisions_match_cpu": True}


def _chaos_object(cfg: Config, ocfg: ObjectLegConfig, device,
                  sync) -> tuple:
    """Leg 3: WindowedSelfJoin with float tick values on the object store
    (``state_backend="object"``, ``substrate="kernels"``: the routing
    kernel on every tuple, step-1 stats through ``key_stats``) against the
    per-tuple loop (``vectorized=False``, numpy, CPU): identical outputs
    and emitted sum, loads within 1e-5 and c(k) within 1e-6 relative."""
    from repro_torch import WindowedSelfJoin
    from repro_torch.kernels import key_stats, route_keys
    from repro_torch.streams import WorkloadGen
    from repro_torch.streams import backends as backends_mod
    ocell = dataclasses.replace(cfg, k=ocfg.k)
    stage = make_stage(ocell, "object", "kernels", device,
                       operator=WindowedSelfJoin(probe_cost=ocfg.probe_cost))
    oracle = make_stage(ocell, "object", "numpy", "cpu",
                        operator=WindowedSelfJoin(probe_cost=ocfg.probe_cost),
                        vectorized=False)
    gen = WorkloadGen(k=ocfg.k, z=cfg.z, f=cfg.f, seed=cfg.seed,
                      window=cfg.window)
    rng = np.random.default_rng(cfg.seed + 2)
    key_sums = backends_mod.key_sums
    stats_input = []

    def recording_key_sums(keys, w1, w2, num):
        stats_input[:] = [keys, w1, w2, num]
        return key_sums(keys, w1, w2, num)

    backends_mod.key_sums = recording_key_sums
    interval_ms, oracle_ms, route_n, stats_n = [], [], [], []
    try:
        for i in range(ocfg.intervals):
            if i:
                gen.interval(stage.controller.assignment)
            keys = gen.draw_tuples(ocfg.tuples).astype(np.int64)
            # a tick: price around 100 in cents, one value per tuple
            ticks = np.round(100.0 + rng.normal(0, 2.0, keys.size), 2)
            r0, s0 = route_keys.launches, key_stats.launches
            sync()
            t0 = time.perf_counter()
            got = stage.process_interval_arrays(keys, ticks)
            sync()
            interval_ms.append((time.perf_counter() - t0) * 1e3)
            route_n.append(route_keys.launches - r0)
            stats_n.append(key_stats.launches - s0)
            t0 = time.perf_counter()
            want = oracle.process_interval_arrays(keys, ticks)
            oracle_ms.append((time.perf_counter() - t0) * 1e3)
            _finite_report(got, cfg.n_tasks)
            _same_report(got, want, exact=False)
            ls, lw = stage.last_stats, oracle.last_stats
            np.testing.assert_array_equal(ls.keys, lw.keys)
            np.testing.assert_array_equal(ls.freq, lw.freq)
            np.testing.assert_allclose(ls.cost, lw.cost, rtol=1e-6)
            if stage.controller.assignment.table != \
                    oracle.controller.assignment.table:
                raise AssertionError(f"object leg, interval {i + 1}: "
                                     "routing tables differ")
    finally:
        backends_mod.key_sums = key_sums
    if (stage.outputs != oracle.outputs
            or stage.emitted_sum != oracle.emitted_sum
            or stage.total_state_keys() != oracle.total_state_keys()):
        raise AssertionError("object leg: outputs differ from the per-tuple "
                             "loop")
    med = statistics.median(interval_ms)
    return {
        "operator": "selfjoin", "keys": ocfg.k, "intervals": ocfg.intervals,
        "tuples_per_interval": ocfg.tuples,
        "interval_ms": interval_ms, "interval_ms_median": med,
        "tuples_per_s": ocfg.tuples / med * 1e3,
        "per_tuple_loop_interval_ms": oracle_ms,
        "held_keys": stage.total_state_keys(),
        "table_size": stage.controller.assignment.table_size,
        "theta": [r.theta for r in stage.reports],
        "route_launches": route_n, "stats_launches": stats_n,
        "last_keys": keys.astype(np.int32),
        "matches_per_tuple_loop": True}, stage, stats_input


# -- phases 5 and 6: the serving slices -----------------------------------------

class FlashSpy:
    """While installed (``with``), stands in for the flash wrapper that
    ``models.attention`` calls: counts each call by window and, while
    ``check`` is set, holds its output against the plain version on the same
    q, k, v (:func:`flash_err_over_tol`)."""

    def __init__(self, torch):
        from repro_torch.models import attention as attn_mod
        self.torch = torch
        self.attn_mod = attn_mod
        self.wrapped = attn_mod.flash_attention
        self.calls: dict = {}
        self.check = False
        self.errs: list = []
        self.ratios: list = []
        #: the last call's (q, k, v)
        self.last = None

    def __enter__(self):
        self.attn_mod.flash_attention = self
        return self

    def __exit__(self, *exc):
        self.attn_mod.flash_attention = self.wrapped

    def __call__(self, q, k, v, causal=True, window=0):
        from repro_torch.kernels import flash_attention_plain
        self.calls[window] = self.calls.get(window, 0) + 1
        self.last = (q, k, v)
        o = self.wrapped(q, k, v, causal=causal, window=window)
        if self.check:
            want = flash_attention_plain(q, k, v, causal=causal,
                                         window=window).float()
            self.errs.append(float((o.float() - want).abs().max()))
            self.ratios.append(flash_err_over_tol(self.torch, o, want, v))
        return o

    def per_call(self) -> dict:
        return {"calls": len(self.ratios),
                "max_abs_err": max(self.errs, default=0.0),
                "worst_err_over_tol": max(self.ratios, default=0.0),
                "tolerance": "FLASH_ATOL[dtype] * rms(v) + eps(dtype) * "
                             "|plain|"}


def timed(sync, fn):
    """``fn()`` and its wall seconds, between two synchronisations."""
    sync()
    t0 = time.perf_counter()
    res = fn()
    sync()
    return res, time.perf_counter() - t0


@contextlib.contextmanager
def perf_flags(names):
    """Exactly the ``REPRO_PERF_*`` flags ``names`` set in this process's
    environment within the block (``repro_torch.flags``), the environment
    as it was after it."""
    saved = {k: v for k, v in os.environ.items()
             if k.startswith("REPRO_PERF_")}
    for k in saved:
        del os.environ[k]
    os.environ.update({f"REPRO_PERF_{n}": "1" for n in names})
    try:
        yield
    finally:
        for k in [k for k in os.environ if k.startswith("REPRO_PERF_")]:
            del os.environ[k]
        os.environ.update(saved)


def cache_free_steps(torch, cfg, params, batch, spy: FlashSpy, sync,
                     *extra) -> tuple:
    """(1) The cache-free step through the flash kernel, then (2) through
    the plain, query-chunked attention, on ``params`` and ``batch``
    (``extra`` goes to every step: an MoE model's placements). The first
    flash call holds every kernel output against the plain version on the
    model's own activations; the second, identical call of each step is
    timed. Returns the two steps' float32 logits, their metrics and the
    flash counter's rise in each."""
    from repro_torch.kernels import flash_attention
    from repro_torch.train.train_step import make_serve_step
    n_tokens = batch["tokens"].numel()
    out, launches = {}, {}
    step = make_serve_step(cfg, use_flash=True)
    spy.check = True
    step(params, None, batch, 0, *extra)
    spy.check = False
    spy.calls.clear()
    flash_attention.launches = 0
    (flash_logits, _), secs = timed(
        sync, lambda: step(params, None, batch, 0, *extra))
    launches["cache_free_flash"] = flash_attention.launches
    out["flash_calls"] = {str(w): n for w, n in sorted(spy.calls.items())}
    out["cache_free_flash"] = {"seconds": secs,
                               "prefill_tokens_per_s": n_tokens / secs}
    out["flash_vs_plain_per_call"] = spy.per_call()
    if out["flash_vs_plain_per_call"]["worst_err_over_tol"] > 1:
        raise AssertionError(f"flash kernel off its plain version on the "
                             f"model's activations: "
                             f"{out['flash_vs_plain_per_call']}")
    step = make_serve_step(cfg, use_flash=False)
    step(params, None, batch, 0, *extra)
    spy.calls.clear()
    flash_attention.launches = 0
    (plain_logits, _), secs = timed(
        sync, lambda: step(params, None, batch, 0, *extra))
    launches["cache_free_plain"] = flash_attention.launches
    out["cache_free_plain"] = {"seconds": secs,
                               "prefill_tokens_per_s": n_tokens / secs,
                               "flash_calls": sum(spy.calls.values())}
    a = flash_logits.float()
    if a.shape != (batch["tokens"].shape[0], 1, cfg.vocab_padded) or \
            not bool(torch.isfinite(a).all()):
        raise AssertionError(f"cache-free logits malformed: {a.shape}")
    return a, plain_logits.float(), out, launches


def cached_greedy(torch, step, params, cache, batch, tokens: int, sync,
                  *extra, start: int = None, decode_batch=None) -> tuple:
    """Prefill ``batch`` through ``cache``, then ``tokens`` greedy decode
    steps from index ``start`` (default: the prompt's length), each given
    ``decode_batch`` too (whisper's encoder output) and timed. Returns the
    prefill's logits, its seconds, the decode ms of each step and the
    greedy tokens (batch, tokens)."""
    start = batch["tokens"].shape[1] if start is None else start
    decode_batch = decode_batch or {}
    (logits, cache), prefill_s = timed(
        sync, lambda: step(params, cache, batch, 0, *extra))
    first = logits
    decode_ms, greedy = [], []
    for i in range(tokens):
        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
        greedy.append(nxt[:, 0])
        (logits, cache), secs = timed(sync, lambda: step(
            params, cache, {"tokens": nxt, **decode_batch}, start + i,
            *extra))
        decode_ms.append(secs * 1e3)
    return first, prefill_s, decode_ms, torch.stack(greedy, 1).cpu().numpy()


def phase_serve(torch, cfg, scfg: ServeConfig, device, sync) -> dict:
    """The serve path of the model ``cfg`` on ``device``, at ``scfg``'s batch
    and lengths (a smoke config on the CPU rehearses it). Returns the
    metrics; ``launches`` holds the flash counter's rise in each call and
    ``flash_calls`` the attention calls that reached the flash wrapper, by
    window. ``main`` checks the counters, which stay 0 on the CPU."""
    from repro_torch.kernels import flash_attention
    from repro_torch.launch.serve import init_request, serve_local
    from repro_torch.models import init_cache, schema
    from repro_torch.models.transformer import model_schema
    from repro_torch.train.train_step import make_serve_step

    dev = torch.device(device)
    n_tokens = scfg.batch * scfg.prompt

    out = {"arch": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
           "head_dim": cfg.hd, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
           "windows": [cfg.layer_window(i) for i in range(cfg.n_layers)],
           "batch": scfg.batch, "prompt": scfg.prompt,
           "new_tokens": scfg.tokens,
           "params": schema.count_params(model_schema(cfg)),
           "kv_cache_bytes": 2 * 2 * cfg.n_layers * scfg.batch
           * (scfg.prompt + scfg.tokens) * cfg.n_kv_heads * cfg.hd}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    params, prompt = init_request(
        cfg, scfg.batch, scfg.prompt, dev,
        torch.Generator(device=dev).manual_seed(scfg.seed))
    batch = {"tokens": prompt}
    with FlashSpy(torch) as spy:
        # (1) and (2): the cache-free step through flash, then plain
        a, b, steps, launches = cache_free_steps(torch, cfg, params, batch,
                                                 spy, sync)
        out.update(steps)
        # a secondary check: at this init the model amplifies rounding
        # through its layers, so the logits gap sits near the tolerance
        gap = (a - b).abs()
        out["flash_vs_plain"] = {
            "max_abs_gap": float(gap.max()),
            "max_gap_over_tol": float((gap / (scfg.atol + scfg.rtol
                                              * b.abs())).max()),
            "atol": scfg.atol, "rtol": scfg.rtol}
        torch.testing.assert_close(a, b, atol=scfg.atol, rtol=scfg.rtol)

        # (3) prefill through the KV cache and greedy decode: first the
        # steps serve_local runs, each timed, on the same weights; then
        # serve_local itself, which makes its weights anew
        spy.calls.clear()
        flash_attention.launches = 0
        cache = init_cache(cfg, scfg.batch, scfg.prompt + scfg.tokens, dev)
        _, prefill_s, decode_ms, _ = cached_greedy(
            torch, make_serve_step(cfg), params, cache, batch, scfg.tokens,
            sync)
        del cache
        phase_peak = (torch.cuda.max_memory_allocated()
                      if dev.type == "cuda" else None)
        out["window_slice_loss"] = window_loss_leg(torch, cfg, params, scfg,
                                                   dev, sync)
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        (first, greedy), secs = timed(sync, lambda: serve_local(
            cfg, scfg.batch, scfg.prompt, scfg.tokens, device=dev,
            generator=torch.Generator(device=dev).manual_seed(scfg.seed)))
        launches["cached"] = flash_attention.launches
    if spy.calls:
        raise AssertionError(f"the cached path reached flash: {spy.calls}")
    if greedy.shape != (scfg.batch, scfg.tokens) or \
            not bool(torch.isfinite(first.float()).all()):
        raise AssertionError("serve_local output malformed")
    # secondary: the cached prefill attends through the same plain path as
    # (2); its first token is checked only where (1)'s top-1 margin is
    # clear of twice the gap, which at this init may be no request at all
    torch.testing.assert_close(first.float(), a, atol=scfg.atol,
                               rtol=scfg.rtol)
    top2 = a[:, -1].topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    clear = margin > 2 * out["flash_vs_plain"]["max_abs_gap"]
    want = a[:, -1].argmax(-1).cpu().numpy()
    if not np.array_equal(greedy[clear, 0], want[clear]):
        raise AssertionError(f"prefill's next tokens {greedy[:, 0]} differ "
                             f"from the cache-free step's {want} "
                             f"(margins {margin})")
    out["cached"] = {
        "serve_local_seconds": secs, "prefill_seconds": prefill_s,
        "prefill_tokens_per_s": n_tokens / prefill_s,
        "prefill_vs_flash_max_abs_gap": float((first.float() - a).abs().max()),
        "prefill_vs_plain_max_abs_gap": float((first.float() - b).abs().max()),
        "decode_ms_per_token": decode_ms,
        "decode_ms_per_token_median": statistics.median(decode_ms),
        "first_token_checked_requests": int(clear.sum()),
        "top1_margins": margin.tolist(), "greedy_tokens": greedy.tolist()}
    out["launches"] = launches
    if dev.type == "cuda":
        out["device_memory_peak_bytes"] = max(
            phase_peak, torch.cuda.max_memory_allocated(),
            *(r["peak_bytes"] for r in out["window_slice_loss"][
                "runs"].values()))
    return out


#: the window-slice leg's flags, run by run
WINDOW_LEG_RUNS = (("plain", ()), ("window_slice", ("WINDOW_SLICE",)),
                   ("window_slice_bf16_loss", ("WINDOW_SLICE", "BF16_LOSS")))
#: its gates: the sliced loss against the plain one (float32 sums in
#: another order, through the leg's layers), and the bfloat16-logits loss
#: within the parity tests' bfloat16 ``lm_loss`` tolerance (ROADMAP C11)
WINDOW_LEG_RTOL = {"window_slice": 1e-4, "window_slice_bf16_loss": 5e-3}


def window_loss_leg(torch, cfg, params, scfg: ServeConfig, dev,
                    sync) -> dict:
    """``REPRO_PERF_WINDOW_SLICE`` and ``REPRO_PERF_BF16_LOSS`` on the model
    ``cfg``'s weights ``params`` (the serve phase's, not drawn again): its
    first ``scfg.window_groups`` superblocks at full width in float32
    (gemma3: 5 sliding-window layers and 1 global a superblock), ``lm_loss``
    forward only over 1 x ``scfg.window_seq`` tokens through the plain
    attention, once per ``WINDOW_LEG_RUNS`` flag set. float32, so that the
    sliced and unsliced bands differ only by float32 sums in another order
    and the bfloat16 cast of the logits is the flag's own. Each run's loss,
    ms (the second of two identical calls) and peak device bytes; the gates
    are ``WINDOW_LEG_RTOL``."""
    from repro_torch.models import attention, forward, lm_loss
    from repro_torch.models import logits_from_hidden
    from repro_torch.models.schema import tree_map
    g = scfg.window_groups
    lcfg = dataclasses.replace(cfg, n_layers=cfg.pattern_period * g)
    p = {k: tree_map(lambda a: a.float(), v) for k, v in params.items()
         if k != "groups"}
    p["groups"] = tree_map(lambda a: a[:g].float(), params["groups"])
    gen = torch.Generator(device=dev).manual_seed(scfg.seed + 5)
    toks = torch.randint(0, cfg.vocab, (1, scfg.window_seq + 1),
                         generator=gen, device=dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    runs = {}
    block = attention._attention_block
    try:
        with torch.no_grad():
            for name, names in WINDOW_LEG_RUNS:
                with perf_flags(names):
                    lm_loss(p, lcfg, batch)
                    if dev.type == "cuda":
                        torch.cuda.reset_peak_memory_stats()
                    keys: dict = {}
                    # the key length of every attention block the timed
                    # call computes: the band where the slice is taken
                    attention._attention_block = lambda q, k, *a, **kw: (
                        keys.__setitem__(k.shape[2],
                                         keys.get(k.shape[2], 0) + 1),
                        block(q, k, *a, **kw))[1]
                    loss, secs = timed(sync,
                                       lambda: lm_loss(p, lcfg, batch))
                    attention._attention_block = block
                runs[name] = {
                    "flags": list(names), "loss": float(loss),
                    "ms": secs * 1e3, "key_lengths": {
                        str(n): c for n, c in sorted(keys.items())},
                    "peak_bytes": (torch.cuda.max_memory_allocated()
                                   if dev.type == "cuda" else None)}
            # the bfloat16 logits against the float32 ones on one chunk
            hidden = forward(p, lcfg, batch)[0][:, :scfg.window_seq // 8]
            wide = logits_from_hidden(p, lcfg, hidden)
            with perf_flags(("BF16_LOSS",)):
                narrow = logits_from_hidden(p, lcfg, hidden)
            logit_gap = float((narrow.float() - wide).abs().max())
            del hidden, wide, narrow
    finally:
        attention._attention_block = block
    plain = runs["plain"]["loss"]
    n_window = sum(lcfg.layer_window(i) > 0 for i in range(lcfg.n_layers))
    chunk = min(max(128, attention._CHUNK_ELEMS // scfg.window_seq),
                scfg.window_seq)
    band = str(cfg.layer_window(0) + chunk)
    out = {"n_layers": lcfg.n_layers, "windows": [
        lcfg.layer_window(i) for i in range(lcfg.n_layers)],
           "tokens": scfg.window_seq, "dtype": "float32", "runs": runs,
           "rtol": WINDOW_LEG_RTOL, "band": int(band),
           "bf16_logits_max_abs_gap": logit_gap,
           "rel_gap": {k: abs(runs[k]["loss"] - plain) / abs(plain)
                       for k in WINDOW_LEG_RTOL}}
    bad = {k: v for k, v in out["rel_gap"].items()
           if not (v <= WINDOW_LEG_RTOL[k] and np.isfinite(runs[k]["loss"]))}
    bands = [runs[k]["key_lengths"].get(band, 0) for k in runs]
    if bad or not np.isfinite(plain) or logit_gap == 0 or \
            bands != [0] + [n_window * scfg.window_seq // chunk] * 2:
        raise AssertionError(f"the window-slice leg's losses are off the "
                             f"plain loss, or a flag did not act: {out}")
    return out


def moe_breakdown(torch, cfg, p, placement, batch: int, prompt: int,
                  reps: int, sync, dev) -> dict:
    """Where one MoE layer's time goes at the serve cell's shape, from host
    timers around synchronised calls (median of ``reps``): the whole
    ``moe`` call, and its three expert products with the SiLU alone on a
    dispatch buffer of the same (E, cap, D) shape. The rest is the router,
    the sort and rank, the dispatch gather and the combine."""
    import torch.nn.functional as F
    from repro_torch.models.moe import capacity_for, moe
    g = torch.Generator(device=dev).manual_seed(7)
    h = torch.randn(batch, prompt, cfg.d_model, generator=g,
                    device=dev).to(torch.bfloat16)
    cap = capacity_for(batch * prompt, cfg)
    xs = torch.randn(cfg.moe_experts, cap, cfg.d_model, generator=g,
                     device=dev).to(torch.bfloat16)

    def experts():
        up = torch.bmm(xs, p["w_up"])
        return torch.bmm(F.silu(torch.bmm(xs, p["w_gate"])) * up, p["w_down"])

    def median_ms(fn):
        fn()
        return statistics.median(timed(sync, fn)[1] * 1e3
                                 for _ in range(reps))

    with torch.inference_mode():
        moe_ms = median_ms(lambda: moe(p, cfg, h, placement=placement))
        expert_ms = median_ms(experts)
    flops = 3 * 2 * cfg.moe_experts * cap * cfg.d_model * cfg.d_ff
    return {"tokens": batch * prompt, "capacity": cap,
            "moe_layer_ms": moe_ms, "expert_matmuls_ms": expert_ms,
            "dispatch_router_combine_ms": moe_ms - expert_ms,
            "expert_matmul_tflops": flops / expert_ms * 1e-9,
            "expert_matmul_bound_ms": flops / BF16_FLOPS_PER_S * 1e3}


def phase_serve_moe(torch, cfg, mcfg: MoeServeConfig, device, sync) -> dict:
    """The MoE serve path of the model ``cfg`` on ``device`` at ``mcfg``'s
    batch and lengths (a smoke config on the CPU rehearses it):

    (1) the cache-free step with ``use_flash=True`` under the identity
        placements, each flash output held against the plain version;
    (2) the same step with ``use_flash=False`` (secondary: logits gap);
    (3) ``forward(..., collect_moe=True)`` on the prompt: each layer's
        expert loads sum to tokens x top-k; ``dropped`` per layer;
    (4) one SkewShield placer per layer updated from its layer's measured
        loads (logical, as the placement is the identity);
    (5) ``permute_expert_params`` on the device, then step (1) under the new
        placements: its logits must equal (1)'s within the serve
        tolerance (a placement only relabels experts, so 0 is expected);
    (6) prefill through the KV cache and greedy decode under the new
        placements, each step timed.

    ``launches`` holds the flash counter's rise in (1), (2) and (6)."""
    from repro_torch.kernels import flash_attention
    from repro_torch.launch.serve import init_request
    from repro_torch.models import forward, init_cache, schema
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.skewshield import (SkewShieldPlacer,
                                               permute_expert_params,
                                               placements_array)
    from repro_torch.models.transformer import model_schema
    from repro_torch.train.train_step import make_serve_step

    dev = torch.device(device)
    e, n_layers = cfg.moe_experts, cfg.n_layers
    n_tokens = mcfg.batch * mcfg.prompt
    cap = moe_mod.capacity_for(n_tokens, cfg)
    bytes_per_expert = 3 * cfg.d_model * cfg.d_ff * 2
    out = {"arch": cfg.name, "n_layers": n_layers, "d_model": cfg.d_model,
           "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
           "head_dim": cfg.hd, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
           "experts": e, "top_k": cfg.moe_topk, "batch": mcfg.batch,
           "prompt": mcfg.prompt, "new_tokens": mcfg.tokens,
           "params": schema.count_params(model_schema(cfg)),
           "capacity": cap,
           "dispatch_buffer_bytes": e * cap * cfg.d_model * 2,
           "kv_cache_bytes": 2 * 2 * n_layers * mcfg.batch
           * (mcfg.prompt + mcfg.tokens) * cfg.n_kv_heads * cfg.hd}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    params, prompt = init_request(
        cfg, mcfg.batch, mcfg.prompt, dev,
        torch.Generator(device=dev).manual_seed(mcfg.seed))
    batch = {"tokens": prompt}
    placers = [SkewShieldPlacer(e, mcfg.shards, bytes_per_expert,
                                theta_max=mcfg.theta_max)
               for _ in range(n_layers)]
    ident = placements_array(placers, dev)
    with FlashSpy(torch) as spy:
        # (1) and (2): the cache-free step through flash, then plain
        a, b, steps, launches = cache_free_steps(torch, cfg, params, batch,
                                                 spy, sync, ident)
        out.update(steps)
        step = make_serve_step(cfg, use_flash=True)

        # (3) the expert loads of the prompt, by layer, through either
        # attention path
        moe_fn = moe_mod.moe

        def collect(use_flash):
            dropped = []

            def counting_moe(*args, **kw):
                res = moe_fn(*args, **kw)
                if kw.get("return_stats"):
                    dropped.append(res[1]["dropped"])
                return res

            moe_mod.moe = counting_moe
            try:
                with torch.inference_mode():
                    _, _, loads = forward(params, cfg, batch,
                                          placements=ident,
                                          use_flash=use_flash,
                                          collect_moe=True)
            finally:
                moe_mod.moe = moe_fn
            loads = loads[:, 0].cpu().numpy()           # (n_layers, E)
            if loads.shape != (n_layers, e) or \
                    not (loads.sum(1) == n_tokens * cfg.moe_topk).all():
                raise AssertionError(f"expert loads do not sum to tokens x "
                                     f"top-k in every layer: {loads.sum(1)}")
            return loads, [int(x) for x in dropped]

        loads, dropped = collect(True)
        plain_loads, _ = collect(False)
        out["expert_loads"] = {
            "sum_per_layer": loads.sum(1).tolist(),
            "max_over_mean_per_layer": (loads.max(1) / loads.mean(1))
            .tolist(),
            "dropped_per_layer": dropped}
        # a secondary check: the two attention paths round differently, and
        # at a near-tie of the router a rounding sends a token to another
        # expert; half the loads' L1 gap is the fewest entries that moved.
        # The logits must agree within the serve tolerance where no entry
        # moved; otherwise the gap is reported beside the moves.
        moved = np.abs(loads - plain_loads).sum(1) / 2
        gap = (a - b).abs()
        out["flash_vs_plain"] = {
            "max_abs_gap": float(gap.max()),
            "max_gap_over_tol": float((gap / (mcfg.atol + mcfg.rtol
                                              * b.abs())).max()),
            "atol": mcfg.atol, "rtol": mcfg.rtol,
            "routed_entries_moved_per_layer": moved.tolist(),
            "first_layer_routed_differently":
                int(np.flatnonzero(moved)[0]) if moved.any() else None}
        if not moved.any():
            torch.testing.assert_close(a, b, atol=mcfg.atol, rtol=mcfg.rtol)

        # (4) SkewShield: one placer per layer, from its measured loads
        updates = [pl.update(loads[g]) for g, pl in enumerate(placers)]
        boosted = not any(len(u.moved_experts) for u in updates)
        if boosted:
            hot = loads.copy()
            hot[np.arange(n_layers), np.arange(n_layers) % e] *= \
                mcfg.hot_factor
            updates = [pl.update(hot[g]) for g, pl in enumerate(placers)]
        if not any(len(u.moved_experts) for u in updates):
            raise AssertionError("no placer moved an expert")
        out["skewshield"] = {
            "boosted_one_expert_per_layer": boosted,
            "hot_factor": mcfg.hot_factor if boosted else None,
            "layers_moved": sum(bool(len(u.moved_experts)) for u in updates),
            "per_layer": [{"theta_before": u.theta_before,
                           "theta_after": u.theta_after,
                           "moved_experts": u.moved_experts.tolist(),
                           "migration_bytes": u.migration_bytes,
                           "plan_ms": u.plan_time_s * 1e3}
                          for u in updates]}

        # (5) move the expert weights on the device, then step (1) again
        moe_p = params["groups"]["sub0"]["moe"]
        ident_np = np.arange(e, dtype=np.int32)

        def permute():
            slots = 0
            for g, pl in enumerate(placers):
                if (pl.placement == ident_np).all():
                    continue
                moved = permute_expert_params(
                    {k: v[g] for k, v in moe_p.items()}, ident_np,
                    pl.placement)
                for name in ("w_gate", "w_up", "w_down"):
                    moe_p[name][g].copy_(moved[name])
                slots += int((pl.placement != ident_np).sum())
            return slots

        slots, secs = timed(sync, permute)
        out["permute"] = {"slots_rewritten": slots, "seconds": secs,
                          "bytes": slots * bytes_per_expert}
        placed = placements_array(placers, dev)
        spy.calls.clear()
        flash_attention.launches = 0
        (placed_logits, _), secs = timed(
            sync, lambda: step(params, None, batch, 0, placed))
        launches["cache_free_flash_placed"] = flash_attention.launches
        delta = (placed_logits.float() - a).abs()
        out["placement_invariance"] = {"max_abs_delta": float(delta.max()),
                                       "seconds": secs}
        torch.testing.assert_close(placed_logits.float(), a, atol=mcfg.atol,
                                   rtol=mcfg.rtol)

        # (6) prefill through the cache and greedy decode, new placements
        spy.calls.clear()
        flash_attention.launches = 0
        cache = init_cache(cfg, mcfg.batch, mcfg.prompt + mcfg.tokens, dev)
        first, prefill_s, decode_ms, greedy = cached_greedy(
            torch, make_serve_step(cfg), params, cache, batch, mcfg.tokens,
            sync, placed)
        first = first.float()
        launches["cached"] = flash_attention.launches
        out["moe_breakdown"] = moe_breakdown(
            torch, cfg, {k: v[0] for k, v in moe_p.items()}, placed[0],
            mcfg.batch, mcfg.prompt, mcfg.reps, sync, dev)
    if spy.calls:
        raise AssertionError(f"the cached path reached flash: {spy.calls}")
    if greedy.shape != (mcfg.batch, mcfg.tokens) or \
            not bool(torch.isfinite(first).all()):
        raise AssertionError("cached prefill or decode output malformed")
    out["cached"] = {
        "prefill_seconds": prefill_s,
        "prefill_tokens_per_s": n_tokens / prefill_s,
        "prefill_vs_flash_max_abs_gap": float((first - a).abs().max()),
        "decode_ms_per_token": decode_ms,
        "decode_ms_per_token_median": statistics.median(decode_ms),
        "greedy_tokens": greedy.tolist()}
    out["launches"] = launches
    if dev.type == "cuda":
        out["device_memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


# -- phase 7: training ----------------------------------------------------------

def train_memory(cfg, microbatches: int) -> dict:
    """The train step's state in bytes, from the schema: the parameters in
    their dtypes, AdamW's float32 m, v and master, the float32 gradient
    accumulator (with more than one microbatch) and one microbatch's
    gradients in the parameters' dtypes, which arrive a superblock slice at
    a time and are added into the accumulator (one microbatch stacks them
    instead: the same bytes once more)."""
    import torch
    from repro_torch.models.schema import tree_leaves
    from repro_torch.models.transformer import model_schema
    specs = tree_leaves(model_schema(cfg))
    n = sum(int(np.prod(s.shape)) for s in specs)
    params = sum(int(np.prod(s.shape))
                 * torch.empty((), dtype=s.dtype).element_size()
                 for s in specs)
    out = {"params": n, "param_bytes": params, "adamw_bytes": 3 * 4 * n,
           "accumulator_bytes": 4 * n if microbatches > 1 else 0,
           "microbatch_grad_bytes": params if microbatches > 1
           else 2 * params}
    out["state_bytes"] = sum(v for k, v in out.items() if k != "params")
    return out


def _draw_batches(torch, tcfg: TrainPhaseConfig, vocab: int):
    """``data_fn`` of the training launcher's local mode at ``tcfg``'s
    sizes: each call runs pipeline intervals until worker 0 packs a
    batch."""
    from repro_torch.data import KeyedDataPipeline, zipf_sources
    pipe = KeyedDataPipeline(zipf_sources(tcfg.sources, z=1.0),
                             n_workers=1, seq_len=tcfg.seq, vocab=vocab)

    def data_fn(step):
        while True:
            pipe.run_interval(n_docs=tcfg.docs_per_interval)
            b = pipe.worker_batch(0, tcfg.batch)
            if b is not None:
                return {k: torch.from_numpy(v) for k, v in b.items()}

    return data_fn


def _moved(trainer) -> bool:
    return any((p.placement != np.arange(p.e)).any()
               for p in trainer.placers)


def phase_train(torch, cfg, tcfg: TrainPhaseConfig, device, sync) -> dict:
    """The training path of the MoE model ``cfg`` on ``device`` at
    ``tcfg``'s sizes (a smoke config and small sizes on the CPU rehearse
    it): the full-depth leg, the resume leg and the card-against-CPU step
    (see :class:`TrainPhaseConfig`), in a temporary directory removed
    afterwards."""
    import gc
    import shutil
    import tempfile
    from repro_torch.models import schema
    from repro_torch.models.transformer import model_schema
    dev = torch.device(device)
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "experts": cfg.moe_experts,
           "top_k": cfg.moe_topk, "vocab": cfg.vocab,
           "params": schema.count_params(model_schema(cfg)),
           "batch": tcfg.batch, "seq": tcfg.seq,
           "tokens_per_step": tcfg.batch * tcfg.seq,
           "microbatches": tcfg.microbatches, "steps": tcfg.steps,
           "memory_arithmetic": train_memory(cfg, tcfg.microbatches),
           "reduced": [f"resume leg: n_layers {cfg.n_layers} -> "
                       f"{tcfg.resume_layers}",
                       f"card-against-CPU step: n_layers {cfg.n_layers} -> "
                       f"{tcfg.resume_layers}, batch {tcfg.cpu_batch} x "
                       f"{tcfg.cpu_seq} tokens, float32"]}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))

    def release():
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    try:
        out["full_depth"] = _train_full_depth(torch, cfg, tcfg, dev, sync,
                                              tmp / "full")
        release()
        out["resume"] = _train_resume(torch, cfg, tcfg, dev, sync, tmp)
        release()
        out["card_vs_cpu"] = _train_card_vs_cpu(torch, cfg, tcfg, dev, sync)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _train_full_depth(torch, cfg, tcfg: TrainPhaseConfig, dev, sync,
                      ckpt_dir) -> dict:
    """``Trainer`` at ``cfg``'s full depth: every step's loss and grad norm
    finite; ``opt_update`` timed between synchronisations (the rest of a
    step is the loss and its backward); at each rebalance, the loads handed
    to every placer must be the step's physical loads mapped to logical
    experts (C10), and where experts moved, the loss of one fixed batch
    under the old weights and placements must equal, bit for bit, the loss
    under the moved weights and new placements."""
    from repro_torch.models import lm_loss
    from repro_torch.train import OptConfig, Trainer, TrainerConfig
    from repro_torch.train import train_step as train_step_mod

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, OptConfig(lr=tcfg.lr, warmup_steps=tcfg.warmup_steps,
                                total_steps=tcfg.steps),
                 TrainerConfig(total_steps=tcfg.steps,
                               checkpoint_every=tcfg.steps + 1,
                               rebalance_every=tcfg.rebalance_every,
                               microbatches=tcfg.microbatches,
                               skewshield=True, theta_max=tcfg.theta_max),
                 str(ckpt_dir), _draw_batches(torch, tcfg, cfg.vocab),
                 seed=tcfg.seed, device=dev)
    sync()
    init_s = time.perf_counter() - t0
    init_bytes = (torch.cuda.memory_allocated() if dev.type == "cuda"
                  else None)
    gen = torch.Generator(device=dev).manual_seed(tcfg.seed + 1)
    toks = torch.randint(0, cfg.vocab, (tcfg.batch, tcfg.seq + 1),
                         generator=gen, device=dev)
    fixed = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def fixed_loss():
        with torch.no_grad():
            return lm_loss(tr.params, cfg, fixed,
                           placements=tr.placements())

    opt_ms, rebalances = [], []
    run_opt = train_step_mod.opt_update
    run_rebalance = tr._rebalance_experts

    def timed_opt(*args):
        res, secs = timed(sync, lambda: run_opt(*args))
        opt_ms.append(secs * 1e3)
        return res

    def rebalance(expert_load):
        old = [p.placement.copy() for p in tr.placers]
        seen, updates = [], []

        def spy(update):
            def call(loads):
                seen.append(np.asarray(loads).copy())
                updates.append(update(loads))
                return updates[-1]
            return call

        for placer in tr.placers:
            placer.update = spy(placer.update)
        before = fixed_loss()
        try:
            _, secs = timed(sync, lambda: run_rebalance(expert_load))
        finally:
            for placer in tr.placers:
                del placer.update
        for layer, (placer, was) in enumerate(zip(tr.placers, old)):
            if not np.array_equal(seen[layer], expert_load[layer, 0][was]):
                raise AssertionError(f"layer {layer}'s placer was not handed "
                                     "the loads by logical expert")
        moved = [int((p.shard_of_slot(p.placement)
                      != p.shard_of_slot(w)).sum())
                 for p, w in zip(tr.placers, old)]
        rec = {"step": tr.step, "ms": secs * 1e3,
               "layers_moved": sum(m > 0 for m in moved),
               "moved_experts_per_layer": moved,
               "slots_rewritten": int(sum((p.placement != w).sum()
                                          for p, w in zip(tr.placers, old))),
               "theta_before_max": max(u.theta_before for u in updates),
               "theta_after_max": max(u.theta_after for u in updates),
               "plan_ms_sum": sum(u.plan_time_s for u in updates) * 1e3,
               "migration_bytes": sum(u.migration_bytes for u in updates),
               "loads_logical": True}
        if any(moved):
            after = fixed_loss()
            rec["fixed_batch_loss_before"] = float(before)
            rec["fixed_batch_loss_after"] = float(after)
            if not torch.equal(before, after):
                raise AssertionError(f"moving experts changed the loss: "
                                     f"{float(before)} -> {float(after)}")
            rec["loss_bit_identical"] = True
        rebalances.append(rec)

    tr._rebalance_experts = rebalance
    train_step_mod.opt_update = timed_opt
    try:
        hist = tr.run()
    finally:
        train_step_mod.opt_update = run_opt
        del tr._rebalance_experts
    losses = [h["loss"] for h in hist]
    norms = [h["grad_norm"] for h in hist]
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        raise AssertionError(f"non-finite loss or grad norm: {losses}, "
                             f"{norms}")
    if not rebalances:
        raise AssertionError("no SkewShield rebalance was evaluated")
    step_ms = [h["time_s"] * 1e3 for h in hist]
    steady = step_ms[1:] if len(step_ms) > 1 else step_ms
    out = {"init_s": init_s, "losses": losses, "grad_norms": norms,
           "step_ms": step_ms, "step_ms_median_2_on": statistics.median(
               steady),
           "tokens_per_s": tcfg.batch * tcfg.seq
           / (statistics.median(steady) / 1e3),
           "opt_update_ms": opt_ms,
           "loss_backward_ms": [s - o for s, o in zip(step_ms, opt_ms)],
           "rebalances": rebalances,
           "stragglers_flagged": sum(bool(h.get("straggler_suspect"))
                                     for h in hist)}
    if dev.type == "cuda":
        out["device_memory_after_init_bytes"] = init_bytes
        out["device_memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def _tree_gap(torch, a, b) -> float:
    from repro_torch.models.schema import tree_leaves
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _train_resume(torch, cfg, tcfg: TrainPhaseConfig, dev, sync,
                  tmp) -> dict:
    """``resume_steps`` steps straight against half of them, ``save``, a
    fresh ``Trainer``'s ``try_resume`` on the same directory and the other
    half, at full width with ``resume_layers`` layers and an expert move
    before the save: the placements and routing tables must agree exactly
    (C12). Whether the losses, weights and optimizer state agree bit for
    bit is recorded (``bit_identical``, with the largest gaps) and checked
    by ``main`` after the phase's line is out."""
    from repro_torch.train import OptConfig, Trainer, TrainerConfig
    rcfg = dataclasses.replace(cfg, n_layers=tcfg.resume_layers)
    draw = _draw_batches(torch, tcfg, cfg.vocab)
    batches = [draw(s) for s in range(tcfg.resume_steps)]
    half = tcfg.resume_steps // 2
    ocfg = OptConfig(lr=tcfg.lr, warmup_steps=tcfg.warmup_steps,
                     total_steps=tcfg.resume_steps)
    tc = TrainerConfig(total_steps=tcfg.resume_steps,
                       checkpoint_every=tcfg.resume_steps + 1,
                       rebalance_every=1, microbatches=tcfg.microbatches,
                       skewshield=True, theta_max=tcfg.theta_max)

    def trainer(name):
        return Trainer(rcfg, ocfg, tc, str(tmp / name),
                       lambda s: batches[s], seed=tcfg.seed, device=dev)

    straight = trainer("straight")
    hist = straight.run()
    first = trainer("resumed")
    first.run(half)
    if not _moved(first):
        raise AssertionError("no expert moved before the save")
    _, save_s = timed(sync, first.save)
    ckpt_bytes = sum(f.stat().st_size
                     for f in (tmp / "resumed").rglob("*") if f.is_file())
    saved = [p.placement.copy() for p in first.placers]
    del first
    resumed = trainer("resumed")
    ok, restore_s = timed(sync, resumed.try_resume)
    if not ok or resumed.step != half:
        raise AssertionError(f"try_resume failed (step {resumed.step})")
    for placer, want in zip(resumed.placers, saved):
        if not np.array_equal(placer.placement, want):
            raise AssertionError("try_resume did not restore a placement")
    rest = resumed.run(tcfg.resume_steps - half)
    for a, b in zip(resumed.placers, straight.placers):
        if not (np.array_equal(a.placement, b.placement)
                and a.controller.assignment.table
                == b.controller.assignment.table):
            raise AssertionError("the resumed run's placements differ from "
                                 "the straight run's")
    gaps = {"params": _tree_gap(torch, resumed.params, straight.params),
            **{k: _tree_gap(torch, resumed.opt_state[k],
                            straight.opt_state[k])
               for k in ("m", "v", "master")}}
    loss_gaps = [abs(a["loss"] - b["loss"])
                 for a, b in zip(rest, hist[half:])]
    return {"n_layers": rcfg.n_layers,
            "params": sum(int(np.prod(p.shape)) for p in
                          _leaves(straight.params)),
            "straight_losses": [h["loss"] for h in hist],
            "resumed_losses": [h["loss"] for h in rest],
            "layers_moved_before_save": sum(
                bool((w != np.arange(len(w))).any()) for w in saved),
            "placements_equal": True,
            "bit_identical": not any(gaps.values()) and not any(loss_gaps),
            "max_abs_gaps": gaps, "loss_gaps": loss_gaps,
            "checkpoint_bytes": ckpt_bytes,
            "save_ms": save_s * 1e3, "restore_ms": restore_s * 1e3}


def _leaves(tree):
    from repro_torch.models.schema import tree_leaves
    return tree_leaves(tree)


#: the card-against-CPU step's tolerances (float32, TF32 off): the loss
#: (held only where no routed entry differs) and the grad norm relative;
#: the updated master absolute, in units of lr: Adam's first step moves a
#: weight by lr g / (|g| + eps), so an element whose gradient is within
#: rounding of 0 may step the other way (up to 2 lr)
CARD_CPU_TOL = {"loss_rtol": 1e-4, "grad_norm_rtol": 1e-3,
                "master_atol_lr": 2.5}


def _train_card_vs_cpu(torch, cfg, tcfg: TrainPhaseConfig, dev,
                       sync) -> dict:
    """One float32 train step (``microbatches`` 2, ``cpu_batch`` x
    ``cpu_seq`` tokens) of the ``resume_layers``-layer model at full width
    on ``dev`` and on the CPU, both through the port's own code, from the
    same weights and batch: whether the loss, grad norm and updated master
    are within ``CARD_CPU_TOL`` is recorded (``within_tolerance``, checked
    by ``main``); the routed entries that differ are counted."""
    from repro_torch.models import schema
    from repro_torch.models.schema import tree_map
    from repro_torch.models.transformer import model_schema
    from repro_torch.train import OptConfig, make_train_step, opt_init
    ccfg = dataclasses.replace(cfg, n_layers=tcfg.resume_layers)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on")
    gen = torch.Generator().manual_seed(tcfg.seed + 2)
    weights = tree_map(lambda a: a.float(),
                       schema.init(model_schema(ccfg), gen, "cpu"))
    toks = torch.randint(0, cfg.vocab, (tcfg.cpu_batch, tcfg.cpu_seq + 1),
                         generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    ocfg = OptConfig(lr=tcfg.lr, warmup_steps=tcfg.warmup_steps,
                     total_steps=tcfg.steps)
    step = make_train_step(ccfg, ocfg, microbatches=2, collect_moe=True)
    runs = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        p = tree_map(lambda a: a.to(d, copy=True), weights)
        b = {k: v.to(d) for k, v in batch.items()}
        (p, st, m), secs = timed(sync, lambda: step(p, opt_init(p), b))
        runs[name] = (tree_map(lambda a: a.cpu(), st["master"]),
                      {k: v.cpu() for k, v in m.items()}, secs)
    (master_a, ma, secs_a), (master_b, mb, secs_b) = runs["card"], \
        runs["cpu"]
    moved = ((ma["expert_load"] - mb["expert_load"]).abs().sum(-1) / 2)
    moved = moved.reshape(-1).tolist()
    gap = _tree_gap(torch, master_a, master_b)
    over = sum(int(((x - y).abs() > ocfg.lr * 1e-2).sum())
               for x, y in zip(_leaves(master_a), _leaves(master_b)))
    n = sum(x.numel() for x in _leaves(master_a))
    loss_a, loss_b = float(ma["loss"]), float(mb["loss"])
    norm_a, norm_b = float(ma["grad_norm"]), float(mb["grad_norm"])
    out = {"n_layers": ccfg.n_layers, "batch": tcfg.cpu_batch,
           "seq": tcfg.cpu_seq, "dtype": "float32", "tf32": False,
           "tolerance": CARD_CPU_TOL, "loss": [loss_a, loss_b],
           "grad_norm": [norm_a, norm_b],
           "routed_entries_differing_per_layer": moved,
           "loss_held": not any(moved),
           "master_max_abs_gap": gap,
           "master_elements_over_lr_over_100": over,
           "master_elements": n, "card_s": secs_a, "cpu_s": secs_b}
    out["within_tolerance"] = {
        "loss": bool(any(moved) or abs(loss_a - loss_b)
                     <= CARD_CPU_TOL["loss_rtol"] * abs(loss_b)),
        "grad_norm": abs(norm_a - norm_b)
        <= CARD_CPU_TOL["grad_norm_rtol"] * abs(norm_b),
        "master": gap <= CARD_CPU_TOL["master_atol_lr"] * ocfg.lr}
    return out


# -- large routing tables and the other archs ---------------------------------

@dataclasses.dataclass(frozen=True)
class LargeTableConfig:
    """A routing table past the compact layout's 16,384 slots (ROADMAP
    C13): the stream deployment's WordCount stage with ``installed`` keys
    in its table (24,000: 32,768 slots once the engine pads the table to a
    power of two), theta_max high enough that no interval plans, so the
    table stays as installed; ``intervals`` intervals of ``tuples``."""

    installed: int = 24_000
    tuples: int = 1_000_000
    intervals: int = 3
    theta_max: float = 100.0


def phase_large_table(cfg: Config, lcfg: LargeTableConfig, device,
                      sync) -> tuple:
    """A ``device``/``kernels`` stage with the large table against the CPU
    columnar stage with the same table: the routes of every key, the
    reports, outputs and emitted sum identical. Returns (metrics, the
    table's arrays at the stage's padded capacity and its dense domain,
    for the kernel's row, and the routing launches in the stage's
    intervals)."""
    from repro_torch.kernels import route_keys
    from repro_torch.streams import WorkloadGen
    tcfg = dataclasses.replace(cfg, theta_max=lcfg.theta_max,
                               table_max=2 * lcfg.installed)
    dev = make_stage(tcfg, "device", "kernels", device)
    ref = make_stage(tcfg, "columnar", "numpy", "cpu")
    rng = np.random.default_rng(cfg.seed + 13)
    keys = rng.choice(cfg.k, size=lcfg.installed, replace=False)
    table = dict(zip(keys.tolist(),
                     rng.integers(0, cfg.n_tasks, keys.size).tolist()))
    for stage in (dev, ref):
        stage.controller.assignment.table = dict(table)
    gen = WorkloadGen(k=cfg.k, z=cfg.z, f=cfg.f, seed=cfg.seed,
                      window=cfg.window)
    interval_ms, launches = [], 0
    for i in range(lcfg.intervals):
        if i:
            gen.interval(dev.controller.assignment)
        tuples = gen.draw_tuples(lcfg.tuples).astype(np.int64)
        before = route_keys.launches
        sync()
        t0 = time.perf_counter()
        got = dev.process_interval_arrays(tuples)
        sync()
        interval_ms.append((time.perf_counter() - t0) * 1e3)
        launches += route_keys.launches - before
        _same_report(got, ref.process_interval_arrays(tuples), exact=True)
        # the dense dest table the interval routed with, every key id
        routes = dev.backend._dest_dense_arrays()[1]
        if not np.array_equal(routes, ref.controller.assignment.dest(
                np.arange(routes.size))):
            raise AssertionError(f"interval {i + 1}: routes differ from the "
                                 "CPU assignment")
    if dev.outputs != ref.outputs or dev.emitted_sum != ref.emitted_sum:
        raise AssertionError("outputs differ from the CPU reference")
    slots = dev._table_capacity
    if dev.controller.assignment.table_size != lcfg.installed or \
            slots <= 16384:
        raise AssertionError(f"the table did not stay past 16,384 slots: "
                             f"{dev.controller.assignment.table_size} "
                             f"entries, {slots} slots")
    tk, td = dev.controller.assignment.table_arrays(slots)
    return ({"table_keys_installed": lcfg.installed, "table_slots": slots,
             "intervals": lcfg.intervals,
             "tuples_per_interval": lcfg.tuples, "interval_ms": interval_ms,
             "routes_match_cpu": True, "reports_match_cpu": True},
            (tk, td, dev.backend.fleet.domain), launches)


# -- the sharded backend --------------------------------------------------------

SHARDED_INTERVALS = 8
SHARDED_REPLAY = 2


def one_rank_group(dev):
    """A one-rank default process group for the body of a ``with``: NCCL
    on the card, gloo on the CPU, rendezvous through a ``FileStore`` in a
    temporary directory (no network)."""
    import contextlib
    import datetime
    import os
    import tempfile

    import torch.distributed as dist

    @contextlib.contextmanager
    def group():
        with tempfile.TemporaryDirectory() as tmp:
            dist.init_process_group(
                "nccl" if dev.type == "cuda" else "gloo",
                store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
                world_size=1, timeout=datetime.timedelta(seconds=300))
            try:
                yield
            finally:
                dist.destroy_process_group()
    return group()


def phase_sharded(cfg: Config, device, sync, trace: list) -> tuple:
    """The stream cell's deployment on ``state_backend="sharded"`` (the
    routing kernel on the ``"kernels"`` substrate) over a one-rank process
    group, NCCL on the card and gloo on the CPU, rendezvous through a
    ``FileStore`` in a temporary directory (no network), against a
    ``device`` stage on the same traffic in this call: the stream phase's
    8 intervals of keys (``trace``), a ``scale_to`` to ``n_tasks + 2``, a
    checkpoint, its first 2 intervals again, then the restore and the
    replay of those 2. Reports, outputs, emitted sum,
    routing table and the dense routes identical; ``all_to_all_single``
    exactly once an interval, each host-timed between two
    synchronisations. Returns (metrics, the final table's arrays at the
    stage's padded capacity and this rank's key-block length, for the
    kernel's row, and the routing launches of the sharded stage's
    intervals); ``main`` checks the launches."""
    import torch
    import torch.distributed as dist
    dev = torch.device(device)
    a2a = dist.all_to_all_single
    collective_ms = []

    def timed_a2a(*args, **kw):
        sync()
        t0 = time.perf_counter()
        work = a2a(*args, **kw)
        sync()
        collective_ms.append((time.perf_counter() - t0) * 1e3)
        return work

    with one_rank_group(dev):
        dist.all_to_all_single = timed_a2a
        try:
            return _drive_sharded(cfg, device, sync, trace, collective_ms)
        finally:
            dist.all_to_all_single = a2a


def _drive_sharded(cfg: Config, device, sync, trace: list,
                   collective_ms: list) -> tuple:
    from repro_torch.kernels import route_keys
    from repro_torch.streams import checkpoint_stage, restore_stage
    shd = make_stage(cfg, "sharded", "kernels", device)
    ref = make_stage(cfg, "device", "kernels", device)
    versions = []
    versions_seen(shd, versions)
    interval_ms, ref_ms, launches, reports, tables = [], [], [0], [], []

    def run(keys, label: str, against=None, table=None):
        before, calls = route_keys.launches, len(collective_ms)
        sync()
        t0 = time.perf_counter()
        got = shd.process_interval_arrays(keys)
        sync()
        interval_ms.append((time.perf_counter() - t0) * 1e3)
        launches[0] += route_keys.launches - before
        if len(collective_ms) - calls != 1:
            raise AssertionError(f"{label}: {len(collective_ms) - calls} "
                                 "all_to_all_single calls, not 1")
        if against is None:
            t0 = time.perf_counter()
            against = ref.process_interval_arrays(keys)
            sync()
            ref_ms.append((time.perf_counter() - t0) * 1e3)
            # the dense routes each stage routed this interval with, every
            # key id (the padding row past the domain is never read)
            dom = ref.backend.fleet.domain
            sk, sh = shd.backend._dest_dense_cache[0::2]
            rk, rh = ref.backend._dest_dense_cache[0::2]
            if sk[0] != rk[0] or not np.array_equal(sh[:dom], rh[:dom]):
                raise AssertionError(f"{label}: dense routes differ")
            table = dict(ref.controller.assignment.table)
        _same_report(got, against, exact=True)
        if shd.controller.assignment.table != table:
            raise AssertionError(f"{label}: routing tables differ")
        reports.append(against)
        tables.append(table)

    traffic = trace[:SHARDED_INTERVALS] + trace[:SHARDED_REPLAY]
    for i, keys in enumerate(traffic):
        if i == SHARDED_INTERVALS:
            t0 = time.perf_counter()
            shd.scale_to(cfg.n_tasks + 2)
            sync()
            scale_ms = (time.perf_counter() - t0) * 1e3
            ref.scale_to(cfg.n_tasks + 2)
            t0 = time.perf_counter()
            ckpt = checkpoint_stage(shd)
            checkpoint_ms = (time.perf_counter() - t0) * 1e3
        run(keys, f"interval {i + 1}")
    if shd.outputs != ref.outputs or shd.emitted_sum != ref.emitted_sum:
        raise AssertionError("outputs differ from the device stage")
    t0 = time.perf_counter()
    restore_stage(shd, ckpt)
    sync()
    restore_ms = (time.perf_counter() - t0) * 1e3
    for j in range(SHARDED_REPLAY):
        i = SHARDED_INTERVALS + j
        run(traffic[i], f"replayed interval {i + 1}", reports[i], tables[i])
    if shd.outputs != ref.outputs or shd.emitted_sum != ref.emitted_sum:
        raise AssertionError("the replay's outputs differ from the device "
                             "stage's")
    assignment = shd.controller.assignment
    if assignment.table_size == 0:
        raise AssertionError("the sharded stream never rebalanced")
    # the final table at the capacity the stage's next route would pad it to
    slots = max(shd._table_capacity,
                1 << max(0, assignment.table_size - 1).bit_length())
    tk, td = assignment.table_arrays(slots)
    med = statistics.median(interval_ms[:SHARDED_INTERVALS])
    fleet = shd.backend.fleet
    return ({"n_shards": fleet.n_shards, "group_backend": "nccl"
             if fleet.device.type == "cuda" else "gloo",
             "intervals": SHARDED_INTERVALS, "replayed": SHARDED_REPLAY,
             "tuples_per_interval": cfg.tuples, "keys": cfg.k,
             "window": cfg.window, "scaled_to": cfg.n_tasks + 2,
             "key_block": fleet._block,
             "table_size": assignment.table_size,
             "interval_ms": interval_ms, "interval_ms_median": med,
             "tuples_per_s": cfg.tuples / med * 1e3,
             "device_interval_ms": ref_ms,
             "device_interval_ms_median": statistics.median(
                 ref_ms[:SHARDED_INTERVALS]),
             "collective_ms": collective_ms,
             "collective_ms_median": statistics.median(collective_ms),
             "all_to_all_calls": len(collective_ms),
             "scale_to_ms": scale_ms, "checkpoint_ms": checkpoint_ms,
             "restore_ms": restore_ms,
             "versions_routed": sorted(set(versions)),
             "reports_match_device": True, "replay_matches": True},
            (tk, td, fleet._block), launches[0])


@dataclasses.dataclass(frozen=True)
class ArchServeConfig:
    """A serving deployment of one more arch at full width and depth (the
    archs with recurrent layers or a front end, and the dense qwen2-7b,
    granite-8b and granite-20b): ``batch`` requests of ``prompt`` text
    tokens (after internvl2's 256-token vision prefix; against whisper's
    1500 encoder frames, inside its 448-token decoder context), 16 greedy
    tokens each."""

    arch: str
    prompt: int
    batch: int = 4
    tokens: int = 16
    seed: int = 0
    atol: float = 0.3
    rtol: float = 0.05


ARCH_SERVES = (ArchServeConfig("whisper-large-v3", 256),
               ArchServeConfig("internvl2-1b", 1792),
               ArchServeConfig("xlstm-125m", 2048),
               ArchServeConfig("qwen2-7b", 2048),
               ArchServeConfig("granite-8b", 2048),
               ArchServeConfig("granite-20b", 2048))


def _gap(a, b, acfg) -> dict:
    gap = (a - b).abs()
    ratio = float((gap / (acfg.atol + acfg.rtol * b.abs())).max())
    return {"max_abs_gap": float(gap.max()), "max_gap_over_tol": ratio,
            "atol": acfg.atol, "rtol": acfg.rtol,
            "within_tolerance": ratio <= 1}


def phase_serve_arch(torch, cfg, acfg: ArchServeConfig, device,
                     sync) -> dict:
    """One arch's serve path on ``device``: (1) the cache-free step through
    the flash kernel, every output held against the plain version on the
    model's activations; (2) the same step without flash; (3) the cached
    prefill and ``tokens`` greedy decode steps, whisper's frames encoded
    once for them and internvl2's decode index past its prefix. The logits
    gaps (1)-(2) and (3)-(1) are secondary (ROADMAP C3), reported against
    atol/rtol; ``main`` checks the flash counts."""
    from repro_torch.kernels import flash_attention
    from repro_torch.launch.serve import frontend_inputs, init_request
    from repro_torch.models import init_cache, schema
    from repro_torch.models.transformer import encode, model_schema
    from repro_torch.train.train_step import make_serve_step
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(acfg.seed)
    params, prompt = init_request(cfg, acfg.batch, acfg.prompt, dev, gen)
    front = frontend_inputs(cfg, acfg.batch, dev, gen)
    prefix = cfg.prefix_len if "pixel_embeds" in front else 0
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "encoder_layers": cfg.encoder_layers, "d_model": cfg.d_model,
           "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
           "head_dim": cfg.hd, "d_ff": cfg.d_ff, "vocab": cfg.vocab,
           "layer_kinds": {k: kinds.count(k) for k in sorted(set(kinds))},
           "batch": acfg.batch, "prompt": acfg.prompt, "prefix": prefix,
           "encoder_frames": cfg.encoder_seq if "frames" in front else 0,
           "new_tokens": acfg.tokens,
           "params": sum(x.numel() for x in _leaves(params)),
           "schema_params": schema.count_params(model_schema(cfg))}
    if out["params"] != out["schema_params"]:
        raise AssertionError(f"{cfg.name}: {out['params']} parameters, the "
                             f"schema has {out['schema_params']}")
    batch = {"tokens": prompt, **front}
    with FlashSpy(torch) as spy:
        a, b, steps, launches = cache_free_steps(torch, cfg, params, batch,
                                                 spy, sync)
        out.update(steps)
        out["flash_vs_plain"] = _gap(a, b, acfg)
        spy.calls.clear()
        flash_attention.launches = 0
        decode_batch = {}
        if "frames" in front:
            with torch.inference_mode():
                enc, secs = timed(sync, lambda: encode(params, cfg,
                                                       front["frames"]))
            out["encode_seconds"] = secs
            decode_batch = {"encoder_out": enc}
            batch = {"tokens": prompt, **decode_batch}
        cache = init_cache(cfg, acfg.batch, prefix + acfg.prompt
                           + acfg.tokens, dev)
        first, prefill_s, decode_ms, greedy = cached_greedy(
            torch, make_serve_step(cfg), params, cache, batch, acfg.tokens,
            sync, start=prefix + acfg.prompt, decode_batch=decode_batch)
        launches["cached"] = flash_attention.launches
    if spy.calls:
        raise AssertionError(f"the cached path reached flash: {spy.calls}")
    first = first.float()
    if greedy.shape != (acfg.batch, acfg.tokens) or \
            not bool(torch.isfinite(first).all()):
        raise AssertionError(f"{cfg.name}: cached output malformed")
    n_tokens = acfg.batch * (prefix + acfg.prompt)
    out["cached"] = {
        "prefill_seconds": prefill_s,
        "prefill_tokens_per_s": n_tokens / prefill_s,
        "prefill_vs_flash": _gap(first, a, acfg),
        "prefill_vs_plain": _gap(first, b, acfg),
        "decode_ms_per_token": decode_ms,
        "decode_ms_per_token_median": statistics.median(decode_ms),
        "greedy_tokens": greedy.tolist()}
    out["launches"] = launches
    out["attention_layers"] = kinds.count("attn")
    if cuda:
        out["device_memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


@dataclasses.dataclass(frozen=True)
class MambaPhaseConfig:
    """One jamba-1.5-large-398b mamba layer at full width (d_model 8192,
    d_inner 16384, N 16): a bf16 prefill of ``seq`` tokens (``reps`` times)
    and ``decode`` one-token steps from its state; float32 checks of the
    prefill-then-decode state against the full scan on the card, and of
    the card against the CPU at ``cpu_seq`` tokens."""

    arch: str = "jamba_1_5_large_398b"
    batch: int = 1
    seq: int = 2048
    decode: int = 16
    cpu_seq: int = 128
    reps: int = 3
    seed: int = 0
    #: float32 sums in another order over T steps, relative to the largest
    tol_rel: float = 1e-4


def _rel_gap(got, want) -> dict:
    gap = float((got.float().cpu() - want.float().cpu()).abs().max())
    big = float(want.float().abs().max())
    return {"max_abs_gap": gap, "max_abs": big, "rel": gap / big}


def phase_mamba(torch, cfg, mcfg: MambaPhaseConfig, device, sync) -> dict:
    from repro_torch.models import mamba as mamba_mod
    from repro_torch.models import schema
    from repro_torch.models.schema import tree_map
    dev = torch.device(device)
    di, n = cfg.mamba_expand * cfg.d_model, cfg.mamba_d_state
    gen = torch.Generator(device=dev).manual_seed(mcfg.seed)
    sch = mamba_mod.mamba_schema(cfg)
    p = schema.init(sch, gen, dev)
    x = torch.randn((mcfg.batch, mcfg.seq + mcfg.decode, cfg.d_model),
                    generator=gen, device=dev)
    out = {"arch": cfg.name, "d_model": cfg.d_model, "d_inner": di,
           "d_state": n, "d_conv": cfg.mamba_d_conv,
           "dt_rank": max(1, cfg.d_model // 16), "batch": mcfg.batch,
           "seq": mcfg.seq, "params": schema.count_params(sch),
           "scan_tensor_bytes": mcfg.batch * mcfg.seq * di * n * 4}
    xb = x[:, :mcfg.seq].to(torch.bfloat16)
    with torch.inference_mode():
        mamba_mod.mamba(p, cfg, xb)
        sync()
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        ms = []
        for _ in range(mcfg.reps):
            (_, state), secs = timed(sync, lambda: mamba_mod.mamba(p, cfg,
                                                                   xb))
            ms.append(secs * 1e3)
        if cuda:
            out["peak_bytes_above_inputs"] = \
                torch.cuda.max_memory_allocated() - base
        out["bf16_ms"] = ms
        out["bf16_ms_median"] = statistics.median(ms)
        out["tokens_per_s"] = mcfg.batch * mcfg.seq / \
            statistics.median(ms) * 1e3
        dec = []
        for i in range(mcfg.decode):
            xt = x[:, mcfg.seq + i:mcfg.seq + i + 1].to(torch.bfloat16)
            (y, state), secs = timed(sync, lambda: mamba_mod.mamba(
                p, cfg, xt, state=state))
            dec.append(secs * 1e3)
        if not bool(torch.isfinite(y.float()).all()):
            raise AssertionError("mamba decode output not finite")
        out["decode_ms_per_token"] = dec
        out["decode_ms_per_token_median"] = statistics.median(dec)
        del state, y
        # float32: a prefill of seq - decode tokens and decode one-token
        # steps against the full scan of seq tokens, on the card
        p32 = tree_map(lambda a: a.float(), p)
        del p
        x32 = x[:, :mcfg.seq]
        full, fstate = mamba_mod.mamba(p32, cfg, x32)
        pre = mcfg.seq - mcfg.decode
        _, state = mamba_mod.mamba(p32, cfg, x32[:, :pre])
        tail = []
        for i in range(pre, mcfg.seq):
            y, state = mamba_mod.mamba(p32, cfg, x32[:, i:i + 1],
                                       state=state)
            tail.append(y)
        check = _rel_gap(torch.cat(tail, 1), full[:, pre:])
        st = _rel_gap(state["h"], fstate["h"])
        out["prefill_decode_vs_scan_f32"] = {
            "prefill": pre, "decode_steps": mcfg.decode, **check,
            "state_rel": st["rel"]}
        del full, fstate, state, tail
        if cuda:
            torch.cuda.empty_cache()
        # float32: the card against the CPU at cpu_seq tokens
        xs = x32[:, :mcfg.cpu_seq]
        got, _ = mamba_mod.mamba(p32, cfg, xs)
        want, _ = mamba_mod.mamba(tree_map(lambda a: a.cpu(), p32), cfg,
                                  xs.cpu())
        out["card_vs_cpu_f32"] = {"seq": mcfg.cpu_seq,
                                  **_rel_gap(got, want)}
    out["tolerance_rel"] = mcfg.tol_rel
    for name in ("prefill_decode_vs_scan_f32", "card_vs_cpu_f32"):
        if out[name]["rel"] > mcfg.tol_rel or (
                out[name].get("state_rel", 0) > mcfg.tol_rel):
            raise AssertionError(f"mamba {name}: {out[name]}")
    return out


#: the archs the ``train_archs`` phase steps at smoke size
TRAIN_ARCHS = ("jamba_1_5_large_398b", "xlstm-125m", "whisper-large-v3",
               "internvl2-1b")


def phase_train_archs(torch, dev, sync, seed: int = 0) -> dict:
    """``lm_loss`` and one float32 train step (2 microbatches) of each of
    ``TRAIN_ARCHS`` at smoke size, on the card and on the CPU from the same
    weights and batch (tokens, and the launcher's stub front-end input):
    finite losses and grad norms, and whether the loss, grad norm and
    updated master are within ``CARD_CPU_TOL`` (``within_tolerance``,
    checked by ``main``; an MoE model's loss is held only where no routed
    entry differs)."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.train import frontend_batch
    from repro_torch.models import lm_loss, schema
    from repro_torch.models.schema import tree_map
    from repro_torch.models.transformer import model_schema
    from repro_torch.train import OptConfig, make_train_step, opt_init
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on")
    dev = torch.device(dev)
    ocfg = OptConfig(lr=1e-3, warmup_steps=2, total_steps=6)
    out = {}
    for arch in TRAIN_ARCHS:
        cfg = smoke_config(arch)
        gen = torch.Generator().manual_seed(seed)
        weights = tree_map(lambda a: a.float(),
                           schema.init(model_schema(cfg), gen, "cpu"))
        toks = torch.randint(0, cfg.vocab, (4, 33), generator=gen)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                 **{k: v.float() for k, v in
                    frontend_batch(cfg, 4, seed).items()}}
        moe = cfg.moe_experts > 0
        step = make_train_step(cfg, ocfg, microbatches=2, collect_moe=moe)
        runs = {}
        for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
            p = tree_map(lambda a: a.to(d, copy=True), weights)
            b = {k: v.to(d) for k, v in batch.items()}
            with torch.no_grad():
                loss = float(lm_loss(p, cfg, b))
            (p, st, m), secs = timed(sync, lambda: step(p, opt_init(p), b))
            runs[name] = (loss, tree_map(lambda a: a.cpu(), st["master"]),
                          {k: v.cpu() for k, v in m.items()}, secs)
        (la, master_a, ma, sa), (lb, master_b, mb, sb) = runs["card"], \
            runs["cpu"]
        moved = ([] if not moe else
                 ((ma["expert_load"] - mb["expert_load"]).abs().sum(-1) / 2)
                 .reshape(-1).tolist())
        vals = [la, lb, float(ma["loss"]), float(mb["loss"]),
                float(ma["grad_norm"]), float(mb["grad_norm"])]
        if not np.all(np.isfinite(vals)):
            raise AssertionError(f"{arch}: a loss or grad norm is not "
                                 f"finite: {vals}")
        gap = _tree_gap(torch, master_a, master_b)
        rel = CARD_CPU_TOL["loss_rtol"]
        out[cfg.name] = {
            "n_layers": cfg.n_layers, "batch": [4, 32], "dtype": "float32",
            "lm_loss": [la, lb], "step_loss": vals[2:4],
            "grad_norm": vals[4:6],
            "routed_entries_differing_per_layer": moved,
            "loss_held": not any(moved), "master_max_abs_gap": gap,
            "card_s": sa, "cpu_s": sb,
            "within_tolerance": {
                "loss": bool(any(moved) or (
                    abs(la - lb) <= rel * abs(lb)
                    and abs(vals[2] - vals[3]) <= rel * abs(vals[3]))),
                "grad_norm": abs(vals[4] - vals[5])
                <= CARD_CPU_TOL["grad_norm_rtol"] * abs(vals[5]),
                "master": gap <= CARD_CPU_TOL["master_atol_lr"] * ocfg.lr}}
    return {"smoke_card_vs_cpu": out, "tolerance": CARD_CPU_TOL}


# -- the model on a device mesh ------------------------------------------------

def phase_mesh(torch, cfg, mcfg: MeshPhaseConfig, device, sync) -> dict:
    """The serve and train steps of the model ``cfg`` on DTensors under a
    one-rank (1, 1) ("data", "model") mesh on ``device`` (a smoke config on
    the CPU rehearses it), each against the same step without the mesh in
    this call (see the module docstring). ``launches`` holds the flash
    counter's rise in the mesh's cache-free step; ``main`` checks it."""
    from repro_torch import flags
    from repro_torch.kernels import flash_attention
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import init_request
    from repro_torch.models import init_cache, schema
    from repro_torch.models.schema import tree_map
    from repro_torch.models.transformer import cache_schema, model_schema
    from repro_torch.sharding import ctx, rules
    from repro_torch.train import (OptConfig, make_train_step, opt_init,
                                   opt_shardings)
    from repro_torch.train.train_step import make_serve_step

    dev = torch.device(device)
    n_layers, e = cfg.n_layers, cfg.moe_experts
    out = {"arch": cfg.name, "mesh": {"shape": [1, 1],
                                      "axes": ["data", "model"],
                                      "backend": "nccl" if dev.type == "cuda"
                                      else "gloo"},
           "n_layers": n_layers, "batch": mcfg.batch, "prompt": mcfg.prompt,
           "new_tokens": mcfg.tokens}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with one_rank_group(dev):
        mesh = make_mesh((1, 1), ("data", "model"), device_type=dev.type)

        def on_mesh(step):
            def run(*args):
                with ctx.use_mesh(mesh):
                    logits, cache = step(*args)
                return logits.full_tensor(), cache
            return run

        params, prompt = init_request(
            cfg, mcfg.batch, mcfg.prompt, dev,
            torch.Generator(device=dev).manual_seed(mcfg.seed))
        batch = {"tokens": prompt}
        ident = torch.arange(e, dtype=torch.int32, device=dev).repeat(
            n_layers, 1)
        dparams = schema.distribute(
            params, rules.param_shardings(model_schema(cfg), mesh))
        out["param_placements"] = sorted(
            {str(tuple(p.placements)) for p in _leaves(dparams)})

        # (1) the cache-free flash step, without and with the mesh
        flash = make_serve_step(cfg, use_flash=True)
        flash(params, None, batch, 0, ident)
        (plain, _), plain_s = timed(
            sync, lambda: flash(params, None, batch, 0, ident))
        plain = plain.float()
        mesh_flash = on_mesh(flash)
        with FlashSpy(torch) as spy:
            spy.check = True
            mesh_flash(dparams, None, batch, 0, ident)
            spy.check = False
            spy.calls.clear()
            flash_attention.launches = 0
            (got, _), mesh_s = timed(
                sync, lambda: mesh_flash(dparams, None, batch, 0, ident))
            launches = flash_attention.launches
            # the last layer's local q, k, v, which the kernel row times
            flash_inputs = spy.last
            calls = {str(w): n for w, n in sorted(spy.calls.items())}
            per_call = spy.per_call()
        if per_call["worst_err_over_tol"] > 1:
            raise AssertionError(f"flash off its plain version on the "
                                 f"mesh's local shards: {per_call}")
        got = got.float()
        gap = float((got - plain).abs().max())
        out["cache_free"] = {
            "plain_s": plain_s, "mesh_s": mesh_s,
            "mesh_over_plain": mesh_s / plain_s,
            "max_abs_gap": gap, "bit_identical": gap == 0.0,
            "flash_calls": calls, "flash_vs_plain_per_call": per_call}
        if gap:
            torch.testing.assert_close(got, plain, atol=mcfg.atol,
                                       rtol=mcfg.rtol)

        # (2) the cached prefill and greedy decode, without and with it
        seq = mcfg.prompt + mcfg.tokens
        step = make_serve_step(cfg)
        runs = {}
        for name, p, run, cache in (
                ("plain", params, step, lambda: init_cache(
                    cfg, mcfg.batch, seq, dev)),
                ("mesh", dparams, on_mesh(step), lambda: schema.distribute(
                    init_cache(cfg, mcfg.batch, seq, dev),
                    rules.cache_shardings(cache_schema(cfg, mcfg.batch, seq),
                                          mesh, mcfg.batch)))):
            first, prefill_s, decode_ms, greedy = cached_greedy(
                torch, run, p, cache(), batch, mcfg.tokens, sync, ident)
            runs[name] = (first.float(), prefill_s, decode_ms, greedy)
        (fp, pp, dp, gp), (fm, pm, dm, gm) = runs["plain"], runs["mesh"]
        out["decode"] = {
            "prefill_s": [pp, pm], "prefill_mesh_over_plain": pm / pp,
            "decode_ms_median": [statistics.median(dp),
                                 statistics.median(dm)],
            "decode_mesh_over_plain": statistics.median(dm)
            / statistics.median(dp),
            "prefill_max_abs_gap": float((fm - fp).abs().max()),
            "greedy_identical": bool((gm == gp).all()),
            "greedy_tokens": gm.tolist()}
        if not out["decode"]["greedy_identical"]:
            raise AssertionError(f"the mesh's greedy tokens differ from the "
                                 f"unsharded run's: {gm.tolist()} against "
                                 f"{gp.tolist()}")

        # (2b) the serve launcher's flags on the mesh: on one rank G = 1
        # and the decode pin splits nothing, so both steps must be bit for
        # bit the flag-free mesh steps
        arch = cfg.name.replace("-", "_")
        serve_flags = flags.launcher_defaults("serve", arch)
        with perf_flags(serve_flags):
            flash_attention.launches = 0
            (fgot, _), flags_s = timed(
                sync, lambda: mesh_flash(dparams, None, batch, 0, ident))
            flags_launches = flash_attention.launches
            ff, fpre, fdec, fgreedy = cached_greedy(
                torch, on_mesh(step), dparams, schema.distribute(
                    init_cache(cfg, mcfg.batch, seq, dev),
                    rules.cache_shardings(cache_schema(cfg, mcfg.batch, seq),
                                          mesh, mcfg.batch)),
                batch, mcfg.tokens, sync, ident)
        out["flags_serve"] = {
            "flags": list(serve_flags), "cache_free_s": flags_s,
            "cache_free_over_flag_free": flags_s / mesh_s,
            "cache_free_bit_identical": bool(torch.equal(fgot.float(), got)),
            "prefill_bit_identical": bool(torch.equal(ff.float(), fm)),
            "prefill_s": fpre, "decode_ms_median": statistics.median(fdec),
            "greedy_identical": bool((fgreedy == gm).all()),
            "cache_free_flash": flags_launches}
        if not (out["flags_serve"]["cache_free_bit_identical"]
                and out["flags_serve"]["prefill_bit_identical"]
                and out["flags_serve"]["greedy_identical"]):
            raise AssertionError(f"the serve launcher's flags changed the "
                                 f"one-rank mesh's steps: "
                                 f"{out['flags_serve']}")
        del params, dparams, runs

        # (3) one float32 train step at reduced depth, without and with it
        ccfg = dataclasses.replace(cfg, n_layers=mcfg.train_layers)
        if torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("TF32 matmuls are on")
        gen = torch.Generator().manual_seed(mcfg.seed + 3)
        weights = tree_map(lambda a: a.float(),
                           schema.init(model_schema(ccfg), gen, "cpu"))
        toks = torch.randint(0, cfg.vocab,
                             (mcfg.train_batch, mcfg.train_seq + 1),
                             generator=gen)
        tbatch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
        ocfg = OptConfig(lr=mcfg.lr, warmup_steps=2, total_steps=6)
        tstep = make_train_step(ccfg, ocfg, microbatches=2, collect_moe=True)
        shard = rules.param_shardings(model_schema(ccfg), mesh)
        train = {}
        for name in ("plain", "mesh"):
            on = name == "mesh"
            full = (lambda t: t.full_tensor()) if on else (lambda t: t)
            p = tree_map(lambda a: a.to(dev, copy=True), weights)
            p = schema.distribute(p, shard) if on else p
            st = opt_init(p)
            layout = lambda: [str(tuple(x.placements))
                              for x in _leaves(p) + _leaves(st)]
            before = layout() if on else None
            with ctx.use_mesh(mesh if on else None):
                (p, st, m), first_s = timed(sync,
                                            lambda: tstep(p, st, tbatch))
                rec = {"loss": float(m["loss"]),
                       "grad_norm": float(m["grad_norm"]),
                       "loads": m["expert_load"].cpu(),
                       "master": [full(x).to("cpu", copy=True)
                                  for x in _leaves(st["master"])],
                       "first_s": first_s}
                if on:
                    rec["placements_kept"] = layout() == before
                    rec["opt_layout"] = all(
                        tuple(x.placements) == tuple(s_.placements)
                        for x, s_ in zip(_leaves(st["master"]), _leaves(
                            opt_shardings(shard, mesh)["master"])))
                # a second step, timed alone (the first warms up)
                _, rec["step_s"] = timed(sync, lambda: tstep(p, st, tbatch))
            train[name] = rec
        # the train launcher's flags with REPRO_PERF_DEFER_GRAD_SYNC (on one
        # rank bit for bit the flag-free mesh step), then with
        # REPRO_PERF_BF16_ACCUM too (the loss the same; the masters' gap
        # reported, not gated)
        train_flags = flags.launcher_defaults("train", arch) + (
            "DEFER_GRAD_SYNC",)
        for name, names in (("defer", train_flags),
                            ("bf16_accum", train_flags + ("BF16_ACCUM",))):
            with perf_flags(names):
                fstep = make_train_step(ccfg, ocfg, microbatches=2,
                                        collect_moe=True)
                p = schema.distribute(
                    tree_map(lambda a: a.to(dev, copy=True), weights), shard)
                st = opt_init(p)
                with ctx.use_mesh(mesh):
                    (p, st, m), step_s = timed(
                        sync, lambda: fstep(p, st, tbatch))
            train[name] = {
                "flags": list(names), "loss": float(m["loss"]),
                "grad_norm": float(m["grad_norm"]), "step_s": step_s,
                "master": [x.full_tensor().to("cpu", copy=True)
                           for x in _leaves(st["master"])]}
        flagged = {}
        for name in ("defer", "bf16_accum"):
            r, base = train[name], train["mesh"]
            flagged[name] = {
                "flags": r["flags"], "loss": r["loss"],
                "grad_norm": r["grad_norm"], "step_s": r["step_s"],
                "first_step_over_flag_free": r["step_s"] / base["first_s"],
                "loss_equal": r["loss"] == base["loss"],
                "finite": bool(np.isfinite([r["loss"], r["grad_norm"]]).all()),
                "master_max_abs_gap": max(
                    float((x - y).abs().max())
                    for x, y in zip(r["master"], base["master"])),
                "master_max_abs_gap_over_lr": max(
                    float((x - y).abs().max()) for x, y in
                    zip(r["master"], base["master"])) / ocfg.lr}
        flagged["defer"]["bit_identical"] = (
            flagged["defer"]["master_max_abs_gap"] == 0.0
            and train["defer"]["grad_norm"] == train["mesh"]["grad_norm"]
            and flagged["defer"]["loss_equal"])
        if not flagged["defer"]["bit_identical"]:
            raise AssertionError(f"REPRO_PERF_DEFER_GRAD_SYNC changed the "
                                 f"one-rank mesh's train step: {flagged}")
        if not (flagged["bf16_accum"]["finite"]
                and flagged["bf16_accum"]["loss_equal"]):
            raise AssertionError(f"REPRO_PERF_BF16_ACCUM's step: {flagged}")
        gap = max(float((x - y).abs().max()) for x, y in
                  zip(train["mesh"]["master"], train["plain"]["master"]))
        a, b = train["mesh"], train["plain"]
        # one rank runs the same local code on the same card: the routing
        # must be the unsharded step's (C11, C14), so a routed entry that
        # moved fails the phase, and the loss is held regardless
        moved = ((a["loads"] - b["loads"]).abs().sum(-1) / 2)
        moved = moved.reshape(-1).tolist()
        if any(moved):
            raise AssertionError(f"the mesh's train step routed otherwise "
                                 f"than the unsharded step: {moved}")
        out["train"] = {
            "n_layers": ccfg.n_layers, "batch": mcfg.train_batch,
            "seq": mcfg.train_seq, "dtype": "float32",
            "tolerance": CARD_CPU_TOL, "loss": [a["loss"], b["loss"]],
            "grad_norm": [a["grad_norm"], b["grad_norm"]],
            "routed_entries_differing_per_layer": moved,
            "master_max_abs_gap": gap,
            "step_s": [a["step_s"], b["step_s"]],
            "mesh_over_plain": a["step_s"] / b["step_s"],
            "placements_kept": a["placements_kept"],
            "opt_layout": a["opt_layout"], "flags": flagged,
            "within_tolerance": {
                "loss": abs(a["loss"] - b["loss"])
                <= CARD_CPU_TOL["loss_rtol"] * abs(b["loss"]),
                "grad_norm": abs(a["grad_norm"] - b["grad_norm"])
                <= CARD_CPU_TOL["grad_norm_rtol"] * abs(b["grad_norm"]),
                "master": gap <= CARD_CPU_TOL["master_atol_lr"] * ocfg.lr}}
    out["launches"] = {"cache_free_flash": launches,
                       "cache_free_flash_flags": flags_launches}
    out["flash_inputs"] = flash_inputs
    if dev.type == "cuda":
        out["device_memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import (RoutingTable, flash_attention,
                                     key_stats, route_keys)

    cfg = Config()
    scfg = ServeConfig()
    mcfg = MoeServeConfig()
    t0 = time.perf_counter()
    emit({"phase": "build", **phase_build(torch),
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    timer = Timer(torch, cfg.reps)
    rows = phase_kernels(torch, cfg, timer, torch.device("cuda")) + \
        phase_flash(torch, scfg, mcfg, timer, torch.device("cuda"))
    del timer
    emit({"phase": "kernels", "kernels": rows,
          "seconds": time.perf_counter() - t0})

    def sync():
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    route_keys.launches = 0
    key_stats.launches = 0
    stream, record, trace = phase_stream(cfg, "cuda", sync)
    main_launches = {"route_keys": route_keys.launches,
                     "key_stats": key_stats.launches}
    if main_launches["route_keys"] == 0:
        raise AssertionError("the main path never launched the routing "
                             "kernel")
    emit({"phase": "stream", **stream, "launches": main_launches,
          "device_memory_peak_bytes": torch.cuda.max_memory_allocated(),
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    route_keys.launches = 0
    key_stats.launches = 0
    stats = phase_stats(cfg, "cuda", sync, record)
    stats_launches = {"route_keys": route_keys.launches,
                      "key_stats": key_stats.launches}
    if min(stats_launches.values()) == 0:
        raise AssertionError(f"the stats path missed a kernel: "
                             f"{stats_launches}")
    emit({"phase": "stats", **stats, "launches": stats_launches,
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    sketch, (tk, td, domain) = phase_stream_sketch(cfg, "cuda", sync, stream)
    for algorithm, _ in SKETCH_PLANNERS:
        run = sketch[algorithm]
        if run["launches"]["route_keys"] < len(run["versions_routed"]):
            raise AssertionError(
                f"sketch-mode {algorithm}: {run['launches']['route_keys']} "
                f"routing launches for {len(run['versions_routed'])} "
                "assignment versions")
    sketch_launches = sum(sketch[a]["launches"]["route_keys"]
                          for a, _ in SKETCH_PLANNERS)
    timer = Timer(torch, cfg.reps)
    rows.append(routing_row(
        timer, "routing_lookup[dense,sketch]",
        torch.arange(domain + 1, dtype=torch.int32, device="cuda"),
        RoutingTable.from_arrays(tk, td, torch.device("cuda")), cfg))
    del timer
    emit({"phase": "stream_sketch", **sketch, "card": nvidia_smi_line(),
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    route_keys.launches = 0
    key_stats.launches = 0
    topology, topo_launches, (tk, td, domain), stats_input = \
        phase_topology(cfg, "cuda", sync)
    topo_peak = torch.cuda.max_memory_allocated()
    check_topology_launches(topology, topo_launches)
    timer = Timer(torch, cfg.reps)
    rows.append(routing_row(
        timer, "routing_lookup[dense,topology]",
        torch.arange(domain + 1, dtype=torch.int32, device="cuda"),
        RoutingTable.from_arrays(tk, td, torch.device("cuda")),
        dataclasses.replace(cfg, seed=cfg.seed + 1)))
    rows.append(topology_stats_row(timer, stats_input))
    del timer, stats_input
    emit({"phase": "topology", **topology, "launches": topo_launches,
          "kernel_rows": rows[-2:], "device_memory_peak_bytes": topo_peak,
          "card": nvidia_smi_line(), "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    route_keys.launches = 0
    key_stats.launches = 0
    chaos, chaos_launches, (tk, td, domain), (otk, otd, okeys), \
        stats_input = phase_chaos(cfg, ObjectLegConfig(), "cuda", sync,
                                  trace)
    chaos_peak = torch.cuda.max_memory_allocated()
    check_chaos_launches(chaos, chaos_launches)
    timer = Timer(torch, cfg.reps)
    rows.append(routing_row(
        timer, "routing_lookup[dense,chaos]",
        torch.arange(domain + 1, dtype=torch.int32, device="cuda"),
        RoutingTable.from_arrays(tk, td, torch.device("cuda")), cfg))
    rows.append(routing_row(
        timer, "routing_lookup[per_tuple,object]",
        torch.from_numpy(okeys).to("cuda"),
        RoutingTable.from_arrays(otk, otd, torch.device("cuda")), cfg))
    rows.append(topology_stats_row(timer, stats_input, "key_stats[object]"))
    del timer, stats_input
    emit({"phase": "chaos", **chaos, "launches": chaos_launches,
          "kernel_rows": rows[-3:], "device_memory_peak_bytes": chaos_peak,
          "card": nvidia_smi_line(), "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    from repro_torch.configs import get_config
    serve = phase_serve(torch, get_config(scfg.arch), scfg, "cuda", sync)
    want = {str(w): n for w, n in sorted(
        {w: serve["windows"].count(w) for w in set(serve["windows"])}
        .items())}
    flash_launches = serve["launches"]
    if (flash_launches["cache_free_flash"] != serve["n_layers"]
            or serve["flash_calls"] != want):
        raise AssertionError(f"the cache-free step launched the flash "
                             f"kernel {flash_launches['cache_free_flash']} "
                             f"times ({serve['flash_calls']}), not once per "
                             f"layer ({want})")
    if flash_launches["cache_free_plain"] or flash_launches["cached"]:
        raise AssertionError(f"a path without flash launched it: "
                             f"{flash_launches}")
    emit({"phase": "serve", **serve, "card": nvidia_smi_line(),
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    serve_moe = phase_serve_moe(torch, get_config(mcfg.arch), mcfg, "cuda",
                                sync)
    moe_launches = serve_moe["launches"]
    if (moe_launches["cache_free_flash"] != serve_moe["n_layers"]
            or moe_launches["cache_free_flash_placed"]
            != serve_moe["n_layers"]
            or serve_moe["flash_calls"] != {"0": serve_moe["n_layers"]}):
        raise AssertionError(f"the MoE cache-free step did not launch the "
                             f"flash kernel once per layer: {moe_launches}, "
                             f"{serve_moe['flash_calls']}")
    if moe_launches["cache_free_plain"] or moe_launches["cached"]:
        raise AssertionError(f"a MoE path without flash launched it: "
                             f"{moe_launches}")
    emit({"phase": "serve_moe", **serve_moe, "card": nvidia_smi_line(),
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    tcfg = TrainPhaseConfig()
    flash_attention.launches = 0
    route_keys.launches = 0
    key_stats.launches = 0
    train = phase_train(torch, get_config(tcfg.arch), tcfg, "cuda", sync)
    train_launches = {"flash_attention": flash_attention.launches,
                      "route_keys": route_keys.launches,
                      "key_stats": key_stats.launches}
    emit({"phase": "train", **train, "launches": train_launches,
          "card": nvidia_smi_line(), "seconds": time.perf_counter() - t0})
    if any(train_launches.values()):
        raise AssertionError(f"the train path launched a kernel: "
                             f"{train_launches}")
    if not train["resume"]["bit_identical"]:
        raise AssertionError(f"the resumed run differs from the straight "
                             f"run: {train['resume']['max_abs_gaps']}")
    if not all(train["card_vs_cpu"]["within_tolerance"].values()):
        raise AssertionError(f"the card's train step is off the CPU's: "
                             f"{train['card_vs_cpu']}")

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    large, (tk, td, domain), large_launches = phase_large_table(
        cfg, LargeTableConfig(), "cuda", sync)
    if large_launches == 0:
        raise AssertionError("the large-table stage never launched the "
                             "routing kernel")
    timer = Timer(torch, cfg.reps)
    rows.append(routing_row(
        timer, "routing_lookup[dense,large_table]",
        torch.arange(domain + 1, dtype=torch.int32, device="cuda"),
        RoutingTable.from_arrays(tk, td, torch.device("cuda")), cfg))
    del timer
    emit({"phase": "large_table", **large,
          "launches": {"route_keys": large_launches},
          "kernel_rows": rows[-1:], "card": nvidia_smi_line(),
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    route_keys.launches = 0
    key_stats.launches = 0
    sharded, (tk, td, block), sharded_launches = phase_sharded(
        cfg, "cuda", sync, trace)
    del trace
    sharded_peak = torch.cuda.max_memory_allocated()
    if sharded_launches < len(sharded["versions_routed"]):
        raise AssertionError(f"the sharded stage launched the routing kernel "
                             f"{sharded_launches} times for "
                             f"{len(sharded['versions_routed'])} assignment "
                             "versions")
    timer = Timer(torch, cfg.reps)
    rows.append(routing_row(
        timer, "routing_lookup[dense,sharded]",
        torch.arange(block + 1, dtype=torch.int32, device="cuda"),
        RoutingTable.from_arrays(tk, td, torch.device("cuda")),
        dataclasses.replace(cfg, n_tasks=sharded["scaled_to"])))
    del timer
    emit({"phase": "sharded", **sharded,
          "launches": {"route_keys": sharded_launches,
                       "key_stats": key_stats.launches},
          "kernel_rows": rows[-1:], "device_memory_peak_bytes": sharded_peak,
          "card": nvidia_smi_line(), "seconds": time.perf_counter() - t0})

    arch_flash = {}
    for acfg in ARCH_SERVES:
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        res = phase_serve_arch(torch, get_config(acfg.arch), acfg, "cuda",
                               sync)
        n_attn, got = res["attention_layers"], res["launches"]
        if (got["cache_free_flash"] != n_attn or res["flash_calls"]
                != ({"0": n_attn} if n_attn else {})):
            raise AssertionError(f"{acfg.arch}: the cache-free step did not "
                                 f"launch the flash kernel once per decoder "
                                 f"attention layer ({n_attn}): {got}, "
                                 f"{res['flash_calls']}")
        if got["cache_free_plain"] or got["cached"]:
            raise AssertionError(f"{acfg.arch}: a path without flash "
                                 f"launched it: {got}")
        arch_flash[acfg.arch] = got["cache_free_flash"]
        emit({"phase": "serve_arch", **res, "card": nvidia_smi_line(),
              "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    timer = Timer(torch, cfg.reps)
    edge = check_flash_edges(torch, torch.device("cuda"))
    first_row = len(rows)
    for acfg in ARCH_SERVES:
        if not arch_flash[acfg.arch]:
            continue
        mc = get_config(acfg.arch)
        t = acfg.prompt + (mc.prefix_len if mc.frontend == "vision_stub"
                           else 0)
        rows.append(flash_row(torch, timer, f"flash_attention[global,"
                              f"{acfg.arch}]", mc, acfg.batch, t, 0,
                              acfg.seed, torch.device("cuda"), edge))
    del timer
    emit({"phase": "arch_flash_rows", "kernel_rows": rows[first_row:],
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    mamba_cfg = MambaPhaseConfig()
    flash_attention.launches = 0
    mamba = phase_mamba(torch, get_config(mamba_cfg.arch), mamba_cfg, "cuda",
                        sync)
    emit({"phase": "mamba", **mamba,
          "launches": {"flash_attention": flash_attention.launches},
          "card": nvidia_smi_line(), "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    train_archs = phase_train_archs(torch, torch.device("cuda"), sync)
    emit({"phase": "train_archs", **train_archs, "card": nvidia_smi_line(),
          "seconds": time.perf_counter() - t0})
    off = {a: r["within_tolerance"]
           for a, r in train_archs["smoke_card_vs_cpu"].items()
           if not all(r["within_tolerance"].values())}
    if off:
        raise AssertionError(f"a smoke train step on the card is off the "
                             f"CPU's: {off}")

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    mesh_cfg = MeshPhaseConfig()
    flash_attention.launches = 0
    mesh = phase_mesh(torch, get_config(mesh_cfg.arch), mesh_cfg, "cuda",
                      sync)
    mesh_flash = mesh["launches"]["cache_free_flash"]
    if mesh_flash != mesh["n_layers"] or \
            mesh["launches"]["cache_free_flash_flags"] != mesh["n_layers"] or \
            mesh["cache_free"]["flash_calls"] != {"0": mesh["n_layers"]}:
        raise AssertionError(f"the mesh's cache-free step did not launch "
                             f"the flash kernel once per layer: "
                             f"{mesh_flash}, {mesh['cache_free']}")
    if not (all(mesh["train"]["within_tolerance"].values())
            and mesh["train"]["placements_kept"]
            and mesh["train"]["opt_layout"]):
        raise AssertionError(f"the mesh's train step is off the unsharded "
                             f"step's: {mesh['train']}")
    timer = Timer(torch, cfg.reps)
    mc = get_config(mesh_cfg.arch)
    q, k, v = mesh.pop("flash_inputs")
    if q.shape[0] != mesh_cfg.batch or q.shape[1] != mc.n_heads or \
            k.shape[1] != mc.n_kv_heads:
        raise AssertionError(f"the mesh's flash inputs are not the one "
                             f"rank's whole batch and heads: {q.shape}, "
                             f"{k.shape}")
    # timed on the last layer's q, k, v as the mesh step handed them over
    rows.append(flash_row(torch, timer, "flash_attention[global,mesh]", mc,
                          mesh_cfg.batch, mesh_cfg.prompt, 0, mesh_cfg.seed,
                          torch.device("cuda"), edge, qkv=(q, k, v)))
    del timer, q, k, v
    emit({"phase": "mesh", **mesh, "kernel_rows": rows[-1:],
          "card": nvidia_smi_line(), "seconds": time.perf_counter() - t0})

    launches = {"routing_lookup[dense]": main_launches["route_keys"],
                "routing_lookup[dense,sketch]": sketch_launches,
                "routing_lookup[dense,topology]":
                    topo_launches["merge"]["route_keys"],
                "key_stats[topology_split]":
                    topo_launches["split"]["key_stats"],
                "routing_lookup[dense,chaos]":
                    chaos_launches["recovery"]["route_keys"]
                    + chaos_launches["autoscale"]["route_keys"],
                "routing_lookup[per_tuple,object]":
                    chaos_launches["object"]["route_keys"],
                "key_stats[object]": chaos_launches["object"]["key_stats"],
                "routing_lookup[per_tuple]": stats_launches["route_keys"],
                "key_stats[zipf_tuples]": stats_launches["key_stats"],
                "key_stats[stats_path]": stats_launches["key_stats"],
                **{f"flash_attention[window={w}]" if w != "0"
                   else "flash_attention[global]": n
                   for w, n in serve["flash_calls"].items()},
                f"flash_attention[global,D={serve_moe['head_dim']}]":
                    moe_launches["cache_free_flash"],
                "routing_lookup[dense,large_table]": large_launches,
                "routing_lookup[dense,sharded]": sharded_launches,
                **{f"flash_attention[global,{a}]": n
                   for a, n in arch_flash.items() if n},
                "flash_attention[global,mesh]": mesh_flash}
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: {**row, "launches": launches[row["name"]]}[k]
                       for k in keys} for row in rows]})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
