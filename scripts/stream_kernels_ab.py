#!/usr/bin/env python3
"""Time versions of the stream kernels against each other on one GPU.

    python3 scripts/stream_kernels_ab.py SOURCE.cu[:FLAG,...] [...]

Each SOURCE is a version of ``src/repro_torch/csrc/routing_lookup.cu`` or
``src/repro_torch/csrc/key_stats.cu`` (for example the parent commit's,
written out with ``git show HEAD~1:src/repro_torch/csrc/routing_lookup.cu >
build/parent_routing_lookup.cu``); flags after a colon go to ``nvcc`` as
they are (``key_stats.cu:-lineinfo``). Each is built with the
port's ``nvcc`` flags into ``build/stream_ab/`` and called through its C
entry point, as its own wrapper would call it: a version whose library
exports ``routing_lookup_abi`` / ``key_stats_abi`` takes the hash table and
the two-weight interface of this checkout's wrappers; one without takes the
sorted table and the count-and-cost interface of the port's first kernels.

Rows: ``chip_smoke.py``'s four stream kernel rows (routing over the dense
2^20 + 1 domain and over one interval's 4M zipf tuples against the main
path's 3000-entry table; ``key_stats`` over the 4M tuples with float32
costs and over the stats path's (dest, key) groups with float64 weights),
``key_stats[hot_key]``, a zipf z = 1.2 stream with one key in half of 4M
tuples, and ``key_stats[uniform]``, 4M uniform keys, where nothing collides
and one atomic per tuple is what the rate of the L2's atomics allows. Versions of a kernel are timed in turns, in order and then in
reverse, each the median of 25 calls with CUDA events and the L2 flushed
(``chip_smoke.Timer``), each output held against the plain version first
(routing bit-identical; ``key_stats`` g(k) equal and c(k) within the
float32 reordering bound). A call includes what the version's wrapper does
around its launch (zeroing the outputs; a float32 cast of the costs where
the version reads only float32).

Prints one JSON line per measurement (with the bound and its share, and
for ``key_stats`` rows the time of ``torch.bincount`` twice), for each
routing row also the time of ``torch.clone`` of its keys (the same bytes
moved, nothing computed), then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def build(specs) -> list:
    """(label, kind, abi, library) per ``SOURCE[:FLAGS]``, built in
    parallel; prints what ``ptxas`` reports for each."""
    from chip_smoke import emit as chip_smoke_emit
    from repro_torch.kernels import _build
    out = ROOT / "build" / "stream_ab"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, spec in enumerate(specs):
        src, _, flags = spec.partition(":")
        lib = out / f"{i}-{Path(src).stem}.so"
        procs.append((spec, lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS,
             *[f for f in flags.split(",") if f], "-o", str(lib), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    versions = []
    for spec, lib_path, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {spec}:\n{log}")
        chip_smoke_emit({"source": spec, "ptxas": [
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]})
        lib = ctypes.CDLL(str(lib_path))
        kind = "routing" if hasattr(lib, "routing_lookup_launch") else \
            "key_stats"
        abi = getattr(lib, f"{'routing_lookup' if kind == 'routing' else kind}"
                      "_abi", None)
        versions.append((spec, kind, abi() if abi else 1, lib))
    return versions


def routing_call(torch, lib, abi: int, tk, td, keys, n_dest: int,
                 seed: int):
    """A function that routes ``keys`` through one version, as its wrapper
    would (the table is built once, outside the call)."""
    from repro_torch.kernels import RoutingTable
    from repro_torch.kernels.routing_lookup import _out_like, sm_count
    dev = keys.device
    stream = torch.cuda.current_stream().cuda_stream
    n = keys.numel()
    fn = lib.routing_lookup_launch
    fn.restype = ctypes.c_int
    if abi == 1:                         # sorted table, one thread a key
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_uint32, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        skeys, order = torch.sort(torch.from_numpy(tk).to(dev), stable=True)
        sdests = torch.from_numpy(td).to(dev)[order].contiguous()
        grid = min(-(-n // 256), 4 * sm_count(dev))

        def call():
            out = torch.empty_like(keys)
            err = fn(keys.data_ptr(), n, skeys.data_ptr(), sdests.data_ptr(),
                     skeys.numel(), n_dest, seed, out.data_ptr(), grid, 256,
                     stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
            return out
        return call
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_uint32, ctypes.c_int, ctypes.c_uint32,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    table = RoutingTable.from_arrays(tk, td, dev)
    head = min(n, ((-keys.data_ptr()) % 16) // 4)
    grid = max(1, min(sm_count(dev), -(-((n - head) // 4) // 1024)))

    def call():
        out = _out_like(keys)
        err = fn(keys.data_ptr(), n, head, table.buckets.data_ptr(),
                 table.buckets.shape[0], table.n_home, table.max_probe,
                 table.salt, n_dest, seed, out.data_ptr(), grid, stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out
    return call


def key_stats_call(torch, lib, abi: int, keys, costs, num: int):
    """A function that computes (g, c) through one version, as its wrapper
    would: outputs zeroed, costs cast where the version needs it."""
    from repro_torch.kernels.routing_lookup import sm_count
    dev = keys.device
    stream = torch.cuda.current_stream().cuda_stream
    n = keys.numel()
    fn = lib.key_stats_launch
    fn.restype = ctypes.c_int
    if abi == 1:                         # float32 costs, one thread a tuple
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        grid = min(-(-n // 256), 8 * sm_count(dev))

        def call():
            c32 = costs.to(torch.float32)
            freq = torch.zeros(num, dtype=torch.float32, device=dev)
            cost = torch.zeros(num, dtype=torch.float32, device=dev)
            err = fn(keys.data_ptr(), c32.data_ptr(), n, num, freq.data_ptr(),
                     cost.data_ptr(), grid, 256, stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
            return freq, cost
        return call
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    grid = max(1, min(4 * sm_count(dev), -(-n // 2048)))

    def call():
        out = torch.zeros((num, 2), dtype=torch.float32, device=dev)
        err = fn(keys.data_ptr(), None, costs.data_ptr(), costs.element_size(),
                 n, num, out.data_ptr(), grid, stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out[:, 0], out[:, 1]
    return call


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("sources", nargs="+")
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("stream_kernels_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import RoutingTable, key_stats_plain, route_plain

    versions = build(args.sources)
    cfg = chip_smoke.Config()
    dev = torch.device("cuda")
    inputs = chip_smoke.stream_kernel_inputs(cfg)
    tk, td = inputs["table"]
    table = RoutingTable.from_arrays(tk, td, dev)
    rng = np.random.default_rng(12)
    hot = rng.zipf(1.2, size=cfg.tuples) % inputs["domain"]
    hot[rng.random(hot.size) < 0.5] = 7
    inputs["key_stats[hot_key]"] = (
        hot.astype(np.int32),
        rng.uniform(0.5, 1.5, size=hot.size).astype(np.float32),
        inputs["domain"])
    # no skew: what one atomic per tuple costs when nothing collides
    inputs["key_stats[uniform]"] = (
        rng.integers(0, inputs["domain"], size=cfg.tuples).astype(np.int32),
        rng.uniform(0.5, 1.5, size=cfg.tuples).astype(np.float32),
        inputs["domain"])
    timer = chip_smoke.Timer(torch, 25)

    for name in ("routing_lookup[dense]", "routing_lookup[per_tuple]"):
        keys = torch.from_numpy(inputs[name]).to(dev)
        want = route_plain(keys, table, cfg.n_tasks, seed=cfg.seed)
        n = keys.numel()
        lower = chip_smoke.bound(8 * n + 8 * len(table),
                                 n * chip_smoke.ROUTE_OPS_PER_KEY)
        calls = [(spec, routing_call(torch, lib, abi, tk, td, keys,
                                     cfg.n_tasks, cfg.seed))
                 for spec, kind, abi, lib in versions if kind == "routing"]
        for spec, call in calls + calls[::-1]:
            err = float((call() - want).abs().max())
            if err != 0:
                raise AssertionError(f"{spec} {name}: off the plain version")
            ms = timer.ms(call)
            chip_smoke.emit({"row": name, "source": spec, "ms": ms,
                             **lower, "bound_share": lower["bound_ms"] / ms,
                             "max_abs_err": err})
        # a yardstick: reading the keys and writing as many bytes, nothing
        # computed
        ms = timer.ms(lambda: keys.clone())
        chip_smoke.emit({"row": name, "source": "torch clone (yardstick)",
                         "ms": ms, **lower,
                         "bound_share": lower["bound_ms"] / ms})

    for name in ("key_stats[zipf_tuples]", "key_stats[stats_path]",
                 "key_stats[hot_key]", "key_stats[uniform]"):
        keys_np, costs_np, num = inputs[name]
        keys = torch.from_numpy(keys_np).to(dev)
        costs = torch.from_numpy(costs_np).to(dev)
        pfreq, pcost = key_stats_plain(keys, costs, num)
        valid = (keys >= 0) & (keys < num)
        mk, mc = keys[valid], costs[valid].to(torch.float32)
        n = keys.numel()
        lower = chip_smoke.bound(n * (4 + costs.element_size()) + 8 * num,
                                 chip_smoke.STATS_OPS_PER_TUPLE * n)
        library_ms = timer.ms(lambda: (
            torch.bincount(mk, minlength=num),
            torch.bincount(mk, weights=mc, minlength=num)))
        calls = [(spec, key_stats_call(torch, lib, abi, keys, costs, num))
                 for spec, kind, abi, lib in versions if kind == "key_stats"]
        for spec, call in calls + calls[::-1]:
            freq, cost = call()
            if not torch.equal(freq, pfreq):
                raise AssertionError(f"{spec} {name}: g(k) differs")
            cerr = (cost - pcost).abs()
            if bool((cerr > chip_smoke.reorder_bound(torch, pfreq,
                                                      pcost)).any()):
                raise AssertionError(f"{spec} {name}: c(k) beyond float32 "
                                     "reordering")
            ms = timer.ms(call)
            chip_smoke.emit({"row": name, "source": spec, "ms": ms,
                             **lower, "bound_share": lower["bound_ms"] / ms,
                             "library_ms": library_ms,
                             "max_abs_err": float(cerr.max())})
    print(chip_smoke.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
