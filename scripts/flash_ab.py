#!/usr/bin/env python3
"""Time versions of the flash kernel against each other on one GPU.

    python3 scripts/flash_ab.py [--phases] SOURCE.cu [SOURCE.cu ...]

Each SOURCE is a version of ``src/repro_torch/csrc/flash_attention.cu`` with
its C entry point ``flash_attention_launch`` (for example the parent
commit's, written out with ``git show HEAD~1:src/repro_torch/csrc/
flash_attention.cu > build/parent.cu``). Each is built with the port's
``nvcc`` flags into ``build/flash_ab/`` and called directly on the serve
path's bf16 shapes (gemma3-12b: B=4, Hq=16, Hkv=8, T=S=2048, D=240), for
the window-1024 and the global layer. The versions are timed in turns, in
order and then in reverse, each as the median of 25 launches with CUDA
events and the L2 flushed (``chip_smoke.Timer``), and each output is held
against the plain version within 2e-2.

``--phases`` builds with ``-DFLASH_PHASE_CLOCKS``; a version that has the
counters then also reports where its consumer warps' clocks go, as shares
of their total (see ``Phase`` in the source).

Prints one JSON line per measurement, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

PHASES = ("wait_q", "wait_k", "gemm_s", "softmax", "wait_v", "gemm_pv",
          "skipped", "epilogue")


def build(sources, phases: bool) -> list:
    from repro_torch.kernels import _build
    out = ROOT / "build" / "flash_ab"
    out.mkdir(parents=True, exist_ok=True)
    extra = ["-DFLASH_PHASE_CLOCKS"] if phases else []
    procs = []
    for i, src in enumerate(sources):
        lib = out / f"{i}-{Path(src).stem}.so"
        procs.append((lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, *extra, "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = []
    for lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {lib.name}:\n{log}")
        libs.append(ctypes.CDLL(str(lib)))
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("sources", nargs="+")
    parser.add_argument("--phases", action="store_true")
    args = parser.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import flash_attention_plain

    libs = build(args.sources, args.phases)
    launch = []
    for lib in libs:
        fn = lib.flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + \
            [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        launch.append(fn)

    b, hq, hkv, t, d = 4, 16, 8, 2048, 240
    q, k, v = chip_smoke._flash_inputs(torch, (b, hq, hkv, t, t, d),
                                       torch.bfloat16, torch.device("cuda"),
                                       seed=0)
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    timer = chip_smoke.Timer(torch, 25)

    def call(fn, window):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1,
                 b, hq, hkv, t, t, d, 1, window, d ** -0.5, stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    for window in (1024, 0):
        want = flash_attention_plain(q, k, v, causal=True,
                                     window=window).float()
        flops = 4 * d * chip_smoke.admitted_pairs(t, t, True, window) * b * hq
        order = list(range(len(libs)))
        for i in order + order[::-1]:
            o.zero_()
            call(launch[i], window)
            err = float((o.float() - want).abs().max())
            if err > chip_smoke.FLASH_ATOL["bfloat16"]:
                raise AssertionError(f"{args.sources[i]} window={window}: "
                                     f"off the plain version by {err}")
            ms = timer.ms(lambda: call(launch[i], window))
            chip_smoke.emit({"source": args.sources[i], "window": window,
                             "ms": ms, "tflops": flops / ms * 1e-9,
                             "max_abs_err": err})
        for i, lib in enumerate(libs):
            read = getattr(lib, "flash_attention_phase_clocks", None)
            if not args.phases or read is None:
                continue
            read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
            read.restype = ctypes.c_int
            clocks = (ctypes.c_ulonglong * len(PHASES))()
            read(clocks)
            call(launch[i], window)
            torch.cuda.synchronize()
            if read(clocks):
                raise RuntimeError("reading the phase clocks failed")
            total = sum(clocks)
            chip_smoke.emit({"source": args.sources[i], "window": window,
                             "phase_share": {n: c / total for n, c in
                                             zip(PHASES, clocks)}})
    print(chip_smoke.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
