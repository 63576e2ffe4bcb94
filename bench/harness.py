"""Run one cell of the benchmark once.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; the
harness finds every piece by name:

* the configuration at the ``file`` its ``configs`` entry gives,
* the traffic mix at ``bench/traffic/<traffic>.json``,
* the runner that drives the system under test at
  ``bench/runners/<runner>.py`` (the configuration's ``runner``, by default
  ``keyed_stage``), and what it names in turn (an operator's reference at
  ``bench/operators/<operator>.py``),
* each metric's reader at ``bench/metrics/<metric name>.py``.

So a later cell, configuration, mix, operator, runner or metric is added by
files and entries alone. This module does what every run does: it checks
the card, loads the readers, opens the measured window for the runner
(with the spans and the profiler in a traced run), and prints what the
runner measured and judged as one JSON line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

from . import tracing

#: top-level module names that no run may load (compared whole)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
ROOT = Path(__file__).resolve().parents[1]


class Refused(RuntimeError):
    """The run cannot give a result (no card, a forbidden module, a cell
    that is not there); the message says why."""


@dataclasses.dataclass
class Cell:
    root: Path
    bench: dict
    workload: dict
    config: dict
    traffic: dict

    @property
    def name(self) -> str:
        return self.workload["name"]

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / entry["file"]).read_text())
    mix = json.loads((root / "bench" / "traffic"
                      / f"{w['traffic']}.json").read_text())
    return Cell(root, bench, w, config, mix)


def metric_entries(cell: Cell, trace: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: with ``trace`` the per-layer
    metrics whose cells include it (a metric without a ``workloads`` list
    goes where the end-to-end metric it moves is reported), else the
    end-to-end ones reported there."""
    e2e = [m for m in cell.bench["end_to_end"]
           if cell.name in m.get("workloads", [cell.name])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in cell.bench["per_layer"]
            if cell.name in m.get("workloads", [cell.name])
            and m["moves"] in reported]


def load_file(root: Path, part: str, name: str) -> ModuleType:
    """The module ``<root>/bench/<part>/<name>.py``."""
    path = root / "bench" / part / f"{name}.py"
    if not path.is_file():
        raise Refused(f"no {part} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"bench_{part}_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(cell: Cell, name: str) -> ModuleType:
    return load_file(cell.root, "metrics", name)


@dataclasses.dataclass
class Run:
    """What a metric reader reads: the run's settings and measurements."""

    cell: Cell
    setup_s: float = 0.0
    window_s: float = 0.0
    intervals: int = 0                 # intervals completed in the window
    tuples: int = 0                    # their tuples
    interval_ms: List[float] = dataclasses.field(default_factory=list)
    reports: list = dataclasses.field(default_factory=list)
    spans: Dict[str, List[tracing.Call]] = dataclasses.field(
        default_factory=dict)
    trace: Optional[tracing.DeviceTrace] = None
    device: dict = dataclasses.field(default_factory=dict)
    setup: dict = dataclasses.field(default_factory=dict)
    notes: List[str] = dataclasses.field(default_factory=list)

    @property
    def config(self) -> dict:
        return self.cell.config


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


def card_info(device: str, count: int = 1) -> dict:
    """The ``device`` field: the cards a run uses, the peak of the fullest,
    and the power limit it ran under."""
    import torch
    if not device.startswith("cuda"):
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": max(int(torch.cuda.max_memory_allocated(d))
                                     for d in range(count))}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        info["power_limit_w"] = float(smi.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        info["power_limit_w"] = None
    return info


def _device(cell: Cell, device: str) -> Callable[[], None]:
    """Check the card the cell asks for; returns the synchronise call."""
    import torch
    if not device.startswith("cuda"):
        return lambda: None
    if not torch.cuda.is_available():
        raise Refused("torch finds no CUDA device")
    if torch.cuda.device_count() < cell.chips:
        raise Refused(f"the cell asks for {cell.chips} cards; "
                      f"torch finds {torch.cuda.device_count()}")
    torch.cuda.init()
    return torch.cuda.synchronize


@dataclasses.dataclass
class Context:
    """What a runner gets: the cell and the run's settings, the card's
    synchronise call, the metric readers, and where it writes."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    sync: Callable[[], None]
    readers: Dict[str, ModuleType]
    run: Run
    started: float
    log: Callable[[str], None]
    stage_factory: Optional[Callable] = None

    @contextlib.contextmanager
    def window(self, spans: Optional[dict] = None):
        """The measured window. Inside it, in a traced run, the readers'
        spans (and ``spans``, which only mark the host's time) wrap their
        targets and the profiler records; it yields the function that
        marks a range in the trace (a no-op untraced). Opening it ends
        ``setup_s``; closing it reads the ``device`` field (before any
        reference runs) and, traced, the spans and the trace."""
        import torch
        run = self.run
        tracer = tracing.Spans(self.sync)
        with contextlib.ExitStack() as traced:
            if self.trace:
                traced.callback(tracer.remove)
                for reader in self.readers.values():
                    tracer.declare(getattr(reader, "SPANS", {}))
                tracer.declare(spans or {})
                acts = [torch.profiler.ProfilerActivity.CPU]
                if self.device.startswith("cuda"):
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                prof = traced.enter_context(torch.profiler.profile(
                    activities=acts))
            mark = (torch.profiler.record_function if self.trace
                    else lambda _: contextlib.nullcontext())
            self.sync()
            run.setup_s = time.perf_counter() - self.started
            with mark(tracing.WINDOW_MARK):
                yield mark
            run.device = card_info(self.device, self.cell.chips)
        if self.trace:
            run.spans = dict(tracer.calls)
            if self.device.startswith("cuda"):
                run.trace = tracing.read_trace(prof)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path = ROOT,
             started: Optional[float] = None,
             overrides: Optional[dict] = None,
             stage_factory: Optional[Callable] = None,
             log: Callable[[str], None] = lambda s: print(s, file=sys.stderr)
             ) -> dict:
    """One run of cell ``name``; returns the result line's object.

    ``overrides`` (tests) replaces keys of the ``config`` and ``traffic``;
    ``stage_factory`` (the control) builds what stands in the program's
    place, as the runner names it.
    """
    started = time.perf_counter() if started is None else started
    cell = load_cell(name, root)
    for part in ("config", "traffic"):
        getattr(cell, part).update((overrides or {}).get(part, {}))
    sync = _device(cell, device)
    runner = load_file(root, "runners",
                       cell.config.get("runner", "keyed_stage"))
    readers = {m["name"]: load_reader(cell, m["name"])
               for m in metric_entries(cell, trace)}
    run = Run(cell)
    ctx = Context(cell, seed, seconds, trace, device, sync, readers, run,
                  started, log, stage_factory)
    verdict = runner.run(ctx)
    limits = cell.config["limits"]
    metrics = {}
    for m in metric_entries(cell, trace):
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    for line in run.notes:
        log(line)
    checks = verdict["checks"]
    result = {"correct": all(checks[n] <= limits[n] for n in checks),
              "attempted": verdict["attempted"], "failed": verdict["failed"],
              "metrics": metrics, "device": run.device, "setup": run.setup}
    if run.trace is not None:
        run.device.update(busy_s=run.trace.busy_s,
                          window_s=run.trace.window_s)
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["checks"] = {n: {"value": min(checks[n], sys.float_info.max),
                            "limit": limits[n]} for n in checks}
    bad = forbidden_loaded()
    if bad:
        raise Refused(f"forbidden modules loaded: {', '.join(bad)}")
    return result
