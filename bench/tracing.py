"""Spans the benchmark wraps around calls into the program's layers, and
the reading of the profiler's trace.

A span names a call target, ``"package.module:Attr.attr"``, and wraps it
for the traced window only (in its owner, a module or a class: an alias
bound elsewhere keeps the original). The wrapper synchronises the card
before and after the call, marks the call in the profiler's trace
(``torch.profiler.record_function``) and keeps its wall milliseconds,
plus, where the span gives one, what a recorder function reads from the
call's arguments and result. Each per-layer metric's reader declares the
spans it needs (``SPANS``); nothing inside the program is edited.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import importlib
import json
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

#: device activity in a Kineto trace: kernels, copies and fills
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the mark around the whole measured window in the trace
WINDOW_MARK = "bench.window"
#: the mark around each interval the harness hands the stage
INTERVAL_MARK = "engine.interval"
#: breakdown lists keep this many entries
TOP = 10


@dataclasses.dataclass
class Call:
    ms: float
    info: Optional[dict] = None


def _resolve(target: str):
    """``(owner, attribute name)`` of ``"module:Attr.attr"``."""
    module, _, path = target.partition(":")
    owner = importlib.import_module(module)
    *parents, name = path.split(".")
    for p in parents:
        owner = getattr(owner, p)
    return owner, name


class Spans:
    """The wrapped call targets of one traced window."""

    def __init__(self, sync: Callable[[], None]):
        self.sync = sync
        self.calls: Dict[str, List[Call]] = collections.defaultdict(list)
        self._undo: List[Tuple[object, str, object]] = []

    def add(self, name: str, target: str,
            recorder: Optional[Callable] = None) -> None:
        import torch
        owner, attr = _resolve(target)
        orig = owner.__dict__[attr] if isinstance(owner, type) \
            else getattr(owner, attr)
        calls, sync = self.calls[name], self.sync

        @functools.wraps(orig)
        def wrapper(*args, **kwargs):
            sync()
            with torch.profiler.record_function(name):
                t0 = time.perf_counter()
                out = orig(*args, **kwargs)
                sync()
                ms = (time.perf_counter() - t0) * 1e3
            calls.append(Call(ms, recorder(args, kwargs, out)
                              if recorder else None))
            return out

        setattr(owner, attr, wrapper)
        self._undo.append((owner, attr, orig))

    def declare(self, spans: dict) -> None:
        """Add a reader's ``SPANS``: each name maps to a target, a
        ``(target, recorder)`` pair, or a list of them (one span over
        several targets)."""
        for name, targets in spans.items():
            for t in targets if isinstance(targets, list) else [targets]:
                target, recorder = t if isinstance(t, tuple) else (t, None)
                self.add(name, target, recorder)

    def remove(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()


@dataclasses.dataclass
class DeviceTrace:
    """The device's activity over the traced window, from the profiler."""

    window_s: float
    busy_s: float
    events: List[Tuple[str, str, float, float]]    # name, cat, ts_us, dur_us
    device_ops: List[list]
    idle_gaps: List[list]

    def kernels(self, name: str) -> List[Tuple[str, str, float, float]]:
        """The kernels called ``name``: a demangled name whose function
        name (before its arguments, after any namespace) is ``name``."""
        return [e for e in self.events
                if e[1] == "kernel" and function_name(e[0]) == name]


def function_name(demangled: str) -> str:
    """``f`` of ``void (anonymous namespace)::ns::f<T>(int, ...)``."""
    head = demangled.replace("(anonymous namespace)::", "").split("(")[0]
    return head.split("<")[0].split(" ")[-1].rsplit("::", 1)[-1]


def _union(spans) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _idle_by_span(busy, marks, w0: float, w1: float) -> Dict[str, float]:
    """Seconds of the window in which the card was idle, by the innermost
    span the host was in ("harness" outside every span). Spans of one
    thread nest, so a sweep over their edges keeps a stack."""
    edges = sorted([(float(m["ts"]), 1, -float(m.get("dur", 0.0)), m["name"])
                    for m in marks]
                   + [(float(m["ts"]) + float(m.get("dur", 0.0)), 0, 0.0,
                       m["name"]) for m in marks])
    idle: Dict[str, float] = collections.Counter()
    stack: List[str] = []
    b = 0
    t = w0
    for x, opens, _, name in edges + [(w1, 0, 0.0, None)]:
        x = min(max(x, w0), w1)
        if x > t:
            who = stack[-1] if stack else "harness"
            while b < len(busy) and busy[b][1] <= t:
                b += 1
            cover, j = 0.0, b
            while j < len(busy) and busy[j][0] < x:
                cover += min(busy[j][1], x) - max(busy[j][0], t)
                j += 1
            idle[who] += (x - t - cover) / 1e6
            t = x
        if name is None:
            break
        if opens:
            stack.append(name)
        elif name in stack:
            del stack[len(stack) - 1 - stack[::-1].index(name)]
    return idle


def read_trace(prof) -> Optional[DeviceTrace]:
    """Busy time, device operations and idle gaps of the window marked
    :data:`WINDOW_MARK` in a finished ``torch.profiler.profile``, the idle
    time summed by the innermost span the host was in. None if the trace
    holds no window mark."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    marks = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    window = [e for e in marks if e.get("name") == WINDOW_MARK]
    if not window:
        return None
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0].get("dur", 0.0))
    dev = [(str(e.get("name", "")), e["cat"], float(e["ts"]),
            float(e.get("dur", 0.0))) for e in events
           if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
    dev = [e for e in dev if e[2] < w1 and e[2] + e[3] > w0]
    busy = _union((max(ts, w0), min(ts + d, w1)) for _, _, ts, d in dev)
    busy_us = sum(b - a for a, b in busy)
    by_op: Dict[str, float] = collections.Counter()
    for name, _, _, d in dev:
        by_op[name[:120]] += d / 1e6
    idle = _idle_by_span(busy, [m for m in marks
                                if m["name"] != WINDOW_MARK], w0, w1)
    return DeviceTrace(
        window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6, events=dev,
        device_ops=[[n, s] for n, s in by_op.most_common(TOP)],
        idle_gaps=[[n, s] for n, s in idle.most_common(TOP)])
