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
  intervals, then MinTable, MinMig and compact Mixed for 3 each, each held
  interval by interval against the same planner's sketch-mode stage on the
  CPU (``SKETCH_ORACLE``). Per planner: interval, plan and ``ingest`` ms,
  tuples/s, the snapshot's head keys (beside the exact phase's stats
  keys), the sketch's bytes, θ and the routing kernel's launches, which
  must cover every assignment version the stage routed with. Its routing
  table and dense domain also give the kernel a row of its own.
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
  the gap measured in (2).
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

Then one ``{"kernels": [...]}`` line (per kernel and call site: launches on
its path, max error, kernel/plain/library times and the bound), the card's
name and power limit as ``nvidia-smi`` gives them, and last
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
before that line; so does a machine without a CUDA device or a checkout
without ``src/repro_torch``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
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
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention, flash_attention_plain
    edge = check_flash_edges(torch, dev)
    if edge > 1:
        raise AssertionError(f"flash edge cases: {edge:.3g} x tolerance")
    gemma, granite = get_config(scfg.arch), get_config(mcfg.arch)
    cases = [(f"flash_attention[window={w}]" if w
              else "flash_attention[global]", gemma, scfg, w)
             for w in sorted(set(gemma.window_pattern), reverse=True)]
    cases.append((f"flash_attention[global,D={granite.hd}]", granite, mcfg,
                  0))
    rows = []
    for name, cfg, sc, window in cases:
        b, hq, hkv, d = sc.batch, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        t = s = sc.prompt
        q, k, v = _flash_inputs(torch, (b, hq, hkv, t, s, d), torch.bfloat16,
                                dev, sc.seed)
        got = flash_attention(q, k, v, causal=True, window=window)
        want = flash_attention_plain(q, k, v, causal=True, window=window)
        err = float((got.float() - want.float()).abs().max())
        if err > FLASH_ATOL["bfloat16"]:
            raise AssertionError(f"flash window={window}: kernel off its "
                                 f"plain version by {err}")
        if window:
            pos = torch.arange(t, device=dev)
            mask = (pos[None] <= pos[:, None]) & \
                (pos[None] > pos[:, None] - window)
            sdpa_kw = {"attn_mask": mask}
        else:                      # T == S: top-left causal is right-aligned
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
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:31",
            "shape": {"b": b, "hq": hq, "hkv": hkv, "t": t, "s": s, "d": d,
                      "window": window, "dtype": "bfloat16",
                      "admitted_pairs_per_head": pairs},
            "max_abs_err": err, "edge_err_over_tol": edge,
            "library_max_abs_err": lib_err, "ms": kernel_ms,
            # the mask's work (4 D FLOPs an admitted pair) over the time,
            # and the share of the bound the kernel reaches
            "tflops": flops / kernel_ms * 1e-9,
            "bound_share": lower["bound_ms"] / kernel_ms,
            "plain_ms": timer.ms(lambda: flash_attention_plain(
                q, k, v, causal=True, window=window)),
            **lower, "library_ms": timer.ms(sdpa)})
    return rows


# -- phases 3 and 4: the two configurations -------------------------------------

def make_stage(cfg: Config, backend: str, substrate: str, device,
               stats_mode: str = "exact", algorithm: str = "mixed"):
    from repro_torch import (Assignment, BalanceConfig, Hash32, KeyedStage,
                             RebalanceController, WordCount)
    controller = RebalanceController(
        Assignment(Hash32(cfg.n_tasks, seed=cfg.seed)),
        BalanceConfig(theta_max=cfg.theta_max, table_max=cfg.table_max,
                      window=cfg.window),
        algorithm=algorithm, stats_mode=stats_mode)
    return KeyedStage(WordCount(), controller, window=cfg.window,
                      state_backend=backend, substrate=substrate,
                      device=device)


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
    phase)."""
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
    metrics, record = result
    metrics.update({"step_ms": spans["step_ms"],
                    "route_dense_ms": spans["route_ms"],
                    "route_dense_parts_ms": {
                        k: spans[k] for k in ("table_build_ms",
                                              "table_upload_ms",
                                              "kernel_ms")}})
    return metrics, record


def _drive_stream(cfg: Config, dev, ref, gen, sync) -> tuple:
    record, interval_ms, ref_ms, gen_ms = [], [], [], []
    stats_keys, digests = [], []
    for i in range(cfg.intervals):
        t0 = time.perf_counter()
        if i:
            gen.interval(dev.controller.assignment)
        keys = gen.draw_tuples(cfg.tuples).astype(np.int64)
        gen_ms.append((time.perf_counter() - t0) * 1e3)
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
            "reports_match_cpu": True}, record


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
SKETCH_PLANNERS = (("mixed", 8), ("mintable", 3), ("minmig", 3),
                   ("compact_mixed", 3))
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


# -- phases 5 and 6: the serving slices -----------------------------------------

class FlashSpy:
    """While installed (``with``), stands in for the flash wrapper that
    ``models.attention`` calls: counts each call by window and, while
    ``check`` is set, holds its output against the plain version on the same
    q, k, v. Tolerance: the JAX package's (2e-5 f32, 2e-2 bf16 at unit-scale
    inputs) times v's rms, since each output row is a weighted mean of v's
    rows, plus one ulp of the output's dtype."""

    def __init__(self, torch):
        from repro_torch.models import attention as attn_mod
        self.torch = torch
        self.attn_mod = attn_mod
        self.wrapped = attn_mod.flash_attention
        self.calls: dict = {}
        self.check = False
        self.errs: list = []
        self.ratios: list = []

    def __enter__(self):
        self.attn_mod.flash_attention = self
        return self

    def __exit__(self, *exc):
        self.attn_mod.flash_attention = self.wrapped

    def __call__(self, q, k, v, causal=True, window=0):
        from repro_torch.kernels import flash_attention_plain
        self.calls[window] = self.calls.get(window, 0) + 1
        o = self.wrapped(q, k, v, causal=causal, window=window)
        if self.check:
            want = flash_attention_plain(q, k, v, causal=causal,
                                         window=window).float()
            err = (o.float() - want).abs()
            tol = (FLASH_ATOL[str(q.dtype).split(".")[-1]]
                   * float(v.float().pow(2).mean().sqrt())
                   + self.torch.finfo(q.dtype).eps * want.abs())
            self.errs.append(float(err.max()))
            self.ratios.append(float((err / tol).max()))
        return o

    def per_call(self) -> dict:
        return {"calls": len(self.ratios), "max_abs_err": max(self.errs),
                "worst_err_over_tol": max(self.ratios),
                "tolerance": "FLASH_ATOL[dtype] * rms(v) + eps(dtype) * "
                             "|plain|"}


def timed(sync, fn):
    """``fn()`` and its wall seconds, between two synchronisations."""
    sync()
    t0 = time.perf_counter()
    res = fn()
    sync()
    return res, time.perf_counter() - t0


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
                  *extra) -> tuple:
    """Prefill ``batch`` through ``cache``, then ``tokens`` greedy decode
    steps, each call timed. Returns the prefill's logits, its seconds, the
    decode ms of each step and the greedy tokens (batch, tokens)."""
    prompt = batch["tokens"].shape[1]
    (logits, cache), prefill_s = timed(
        sync, lambda: step(params, cache, batch, 0, *extra))
    first = logits
    decode_ms, greedy = [], []
    for i in range(tokens):
        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
        greedy.append(nxt[:, 0])
        (logits, cache), secs = timed(sync, lambda: step(
            params, cache, {"tokens": nxt}, prompt + i, *extra))
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
        del params, cache
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
        out["device_memory_peak_bytes"] = torch.cuda.max_memory_allocated()
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
    from repro_torch.kernels import RoutingTable, key_stats, route_keys

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
    stream, record = phase_stream(cfg, "cuda", sync)
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

    launches = {"routing_lookup[dense]": main_launches["route_keys"],
                "routing_lookup[dense,sketch]": sketch_launches,
                "routing_lookup[per_tuple]": stats_launches["route_keys"],
                "key_stats[zipf_tuples]": stats_launches["key_stats"],
                "key_stats[stats_path]": stats_launches["key_stats"],
                **{f"flash_attention[window={w}]" if w != "0"
                   else "flash_attention[global]": n
                   for w, n in serve["flash_calls"].items()},
                f"flash_attention[global,D={serve_moe['head_dim']}]":
                    moe_launches["cache_free_flash"]}
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
