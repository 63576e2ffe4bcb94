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
  at the shapes the two configurations below give it plus edge cases,
  timed with CUDA events (median of 25 launches, L2 flushed before each).
* ``stream``  — the main path, ``KeyedStage(state_backend="device",
  substrate="kernels")`` on the card: WordCount at the paper's Table II
  defaults (z = 0.85, f = 1.0, 15 tasks, theta_max = 0.08, A_max = 3000),
  K = 10^6 keys, window 5, 4M tuples per interval, 8 intervals. The same
  stream through ``state_backend="columnar", substrate="numpy"`` on the CPU
  must give identical reports, outputs and routing tables.
* ``stats``   — the stats path, ``KeyedStage(state_backend="columnar",
  substrate="kernels")`` on the card, for the stream's first 4 intervals,
  against the same CPU reports (float32 stats: 1e-6 relative).

Then one ``{"kernels": [...]}`` line (per kernel and call site: launches on
its path, max error, kernel/plain/library times and the bytes bound), the
card's name and power limit as ``nvidia-smi`` gives them, and last
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
before that line; so does a machine without a CUDA device or a checkout
without ``src/repro_torch``.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
#: H100 SXM peaks (NVIDIA data sheet, 700 W): device-memory rate, and the
#: non-tensor-core float32 rate, taken for the kernels' 32-bit integer and
#: float operations (no tensor-core work in either kernel)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
#: 32-bit operations per key of the routing kernel: the fmix32 mix (9),
#: the modulo and sign test (2), and a binary search of the sorted table,
#: 4 per step (index, load, compare, select)
ROUTE_OPS_PER_KEY = 11
ROUTE_OPS_PER_STEP = 4
#: per tuple of key_stats: two range tests and two atomic adds
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


def bound(nbytes: int, ops: int) -> dict:
    """The least time the card could take: the larger of moving ``nbytes``
    (each input read once, each output written once) and doing ``ops``."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / SCALAR_OPS_PER_S * 1e3
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
    """What the stats path hands ``key_stats`` for one WordCount interval:
    one entry per (dest, key) group in (dest, key) order, weighted by its
    tuple count (float64, cast to float32 by the wrapper)."""
    from repro_torch.core import Hash32
    uniq, counts = np.unique(keys, return_counts=True)
    dest = Hash32(cfg.n_tasks, cfg.seed)(uniq)
    order = np.lexsort((uniq, dest))
    return uniq[order].astype(np.int32), counts[order].astype(np.float64)


def check_edge_cases(torch, dev) -> float:
    """The wrappers' contracts on the card; returns the largest error."""
    from repro_torch.core import Hash32
    from repro_torch.kernels import (RoutingTable, key_stats, route_keys,
                                     route_plain, routing_lookup)
    from repro_torch.core.balancer import fmix32

    def i32(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int32)).to(dev)

    err = 0.0
    probe = np.arange(4096, dtype=np.int64)
    high = probe[fmix32(probe.astype(np.uint32), 5) >= 2**31][:64]
    edge = np.concatenate([[0, 1, 2**31 - 2, 2**31 - 1], high])
    for a in (1, 128, 16384):          # 16384 slots: 128 KB of shared memory
        tk = np.full(a, -1, np.int64)
        td = np.zeros(a, np.int64)
        tk[0], td[0] = 2**31 - 1, 11
        table = RoutingTable(i32(tk), i32(td))
        got = route_keys(i32(edge), table, 13, seed=5).cpu().numpy()
        want = Hash32(13, 5)(edge)
        want[3] = 11
        err = max(err, float(np.abs(got - want).max()))
        err = max(err, float((route_keys(i32(edge), table, 13, seed=5)
                              - route_plain(i32(edge), table, 13, seed=5))
                             .abs().max()))
    if route_keys(i32([]), table, 13).numel() != 0:
        raise AssertionError("routing an empty key batch returned keys")
    try:
        routing_lookup(i32([4]), i32([4, -1, 4]), i32([1, 0, 2]), 10)
    except ValueError:
        pass
    else:
        raise AssertionError("duplicate table keys were not refused")
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
    return err


def phase_kernels(torch, cfg: Config, timer: Timer, dev):
    """Each kernel against its plain version, at the main path's shapes."""
    from repro_torch.kernels import (RoutingTable, key_stats, key_stats_plain,
                                     route_keys, route_plain)
    from repro_torch.streams import WorkloadGen
    rng = np.random.default_rng(cfg.seed + 1)
    gen = WorkloadGen(k=cfg.k, z=cfg.z, f=cfg.f, seed=cfg.seed + 1,
                      window=cfg.window)
    keys4m = gen.draw_tuples(cfg.tuples).astype(np.int32)
    tk, td = _table(rng, cfg)
    table = RoutingTable.from_arrays(tk, td, dev)
    domain = 1 << (cfg.k - 1).bit_length()
    edge_err = check_edge_cases(torch, dev)
    if edge_err != 0:
        raise AssertionError(f"edge cases: kernel off by {edge_err}")

    rows = []
    for name, keys_np in (("routing_lookup[dense]",
                           np.arange(domain + 1, dtype=np.int32)),
                          ("routing_lookup[per_tuple]", keys4m)):
        keys = torch.from_numpy(keys_np).to(dev)
        got = route_keys(keys, table, cfg.n_tasks, seed=cfg.seed)
        want = route_plain(keys, table, cfg.n_tasks, seed=cfg.seed)
        err = float((got - want).abs().max())
        if err != 0:
            raise AssertionError(f"{name}: kernel and plain routing differ")
        n = keys.numel()
        steps = max(1, len(table)).bit_length()
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/routing_lookup.cu",
            "replaces": "src/repro/kernels/routing_lookup.py:54",
            "shape": {"n": n, "table_slots": len(table)},
            "max_abs_err": max(err, edge_err),
            "ms": timer.ms(lambda: route_keys(keys, table, cfg.n_tasks,
                                              seed=cfg.seed)),
            "plain_ms": timer.ms(lambda: route_plain(keys, table,
                                                     cfg.n_tasks,
                                                     seed=cfg.seed)),
            **bound(8 * n + 8 * len(table),
                    n * (ROUTE_OPS_PER_KEY + ROUTE_OPS_PER_STEP * steps)),
            "library_ms": None})

    stats_keys, stats_costs = _stats_path_input(keys4m.astype(np.int64), cfg)
    for name, keys_np, costs_np, num in (
            ("key_stats[zipf_tuples]", keys4m,
             rng.uniform(0.5, 1.5, size=keys4m.size).astype(np.float32),
             domain),
            ("key_stats[stats_path]", stats_keys, stats_costs,
             int(stats_keys.max()) + 1)):
        keys = torch.from_numpy(keys_np).to(dev)
        costs = torch.from_numpy(costs_np).to(dev)
        freq, cost = key_stats(keys, costs, num)
        pfreq, pcost = key_stats_plain(keys, costs, num)
        if not torch.equal(freq, pfreq):
            raise AssertionError(f"{name}: kernel and plain g(k) differ")
        # float32 sums of the same terms in two orders: each differs from
        # the exact sum by at most (g(k) - 1) * 2^-24 * c(k) (costs > 0)
        tol = 2.0 * freq * 2.0**-24 * pcost.abs() + 1e-30
        cerr = (cost - pcost).abs()
        if bool((cerr > tol).any()):
            raise AssertionError(f"{name}: kernel and plain c(k) differ "
                                 "beyond float32 reordering")
        valid = (keys >= 0) & (keys < num)
        mk = keys[valid]
        mc = costs[valid].to(torch.float32)
        n = keys.numel()
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/key_stats.cu",
            "replaces": "src/repro/kernels/key_stats.py:31",
            "shape": {"n": n, "num_keys": num},
            "max_abs_err": max(float(cerr.max()), edge_err),
            "ms": timer.ms(lambda: key_stats(keys, costs, num)),
            "plain_ms": timer.ms(lambda: key_stats_plain(keys, costs, num)),
            **bound(8 * n + 8 * num, STATS_OPS_PER_TUPLE * n),
            "library_ms": timer.ms(lambda: (
                torch.bincount(mk, minlength=num),
                torch.bincount(mk, weights=mc, minlength=num)))})
    return rows


# -- phases 3 and 4: the two configurations -------------------------------------

def make_stage(cfg: Config, backend: str, substrate: str, device):
    from repro_torch import (Assignment, BalanceConfig, Hash32, KeyedStage,
                             RebalanceController, WordCount)
    controller = RebalanceController(
        Assignment(Hash32(cfg.n_tasks, seed=cfg.seed)),
        BalanceConfig(theta_max=cfg.theta_max, table_max=cfg.table_max,
                      window=cfg.window))
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


def phase_stream(cfg: Config, device, sync) -> tuple:
    """The main path on ``device`` against columnar + numpy on the CPU.

    Returns (metrics, the CPU reference's per-interval record for the stats
    phase)."""
    from repro_torch.streams import WorkloadGen
    dev = make_stage(cfg, "device", "kernels", device)
    ref = make_stage(cfg, "columnar", "numpy", "cpu")
    gen = WorkloadGen(k=cfg.k, z=cfg.z, f=cfg.f, seed=cfg.seed,
                      window=cfg.window)
    fleet = dev.backend.fleet
    spans = {"step_ms": [], "route_ms": []}

    def timed(fn, key):
        def wrapper(*a, **kw):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            spans[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return wrapper

    fleet.interval_step = timed(fleet.interval_step, "step_ms")
    fleet.route_dense = timed(fleet.route_dense, "route_ms")
    record, interval_ms, ref_ms, gen_ms = [], [], [], []
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
    plans = [ev.result.plan_time_s * 1e3 for ev in dev.controller.history
             if ev.result is not None]
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
            "step_ms": spans["step_ms"], "route_dense_ms": spans["route_ms"],
            "generator_ms": gen_ms, "cpu_reference_interval_ms": ref_ms,
            "theta": [r.theta for r in dev.reports],
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
    from repro_torch.kernels import key_stats, route_keys

    cfg = Config()
    t0 = time.perf_counter()
    emit({"phase": "build", **phase_build(torch),
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    rows = phase_kernels(torch, cfg, Timer(torch, cfg.reps),
                         torch.device("cuda"))
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

    launches = {"routing_lookup[dense]": main_launches["route_keys"],
                "routing_lookup[per_tuple]": stats_launches["route_keys"],
                "key_stats[zipf_tuples]": stats_launches["key_stats"],
                "key_stats[stats_path]": stats_launches["key_stats"]}
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
