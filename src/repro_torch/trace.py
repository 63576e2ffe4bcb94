"""The program's own spans and counters, on the profiler's clock.

A keyed stage's interval opens a record with :func:`begin` and closes it
with :func:`end`. The record is installed only while a
``torch.profiler.profile`` is recording; otherwise the current record is
``None``, :func:`span` returns one shared null context (no
``record_function`` call, no clock read) and :func:`count` returns at once.
There is no other switch.

Under the profiler each :func:`span` opens a
``torch.profiler.record_function`` range, which lands in the profiler's
trace on the same clock as the device's kernels and copies, and adds its
wall seconds to the record's ``spans[name]``; :func:`count` adds to
``counts[name]``. The stage hands the record to the interval's report
(``IntervalReport.trace``).

The current record belongs to the process: one stage's interval at a time,
on one thread.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Optional

import torch


@dataclasses.dataclass
class Record:
    """One interval's spans (wall seconds by name) and counts."""

    spans: Dict[str, float] = dataclasses.field(default_factory=dict)
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)


_NULL = contextlib.nullcontext()
_current: Optional[Record] = None


def begin() -> Optional[Record]:
    """Install a fresh record as the current one if the profiler records,
    else ``None``. Returns the record that was current before, for
    :func:`end`."""
    global _current
    previous = _current
    _current = Record() if torch.autograd._profiler_enabled() else None
    return previous


def end(previous: Optional[Record]) -> Optional[Record]:
    """Restore ``previous`` (what :func:`begin` returned) as the current
    record; returns the record that was current."""
    global _current
    record, _current = _current, previous
    return record


def current() -> Optional[Record]:
    return _current


@contextlib.contextmanager
def _timed(record: Record, name: str):
    with torch.profiler.record_function(name):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            record.spans[name] = (record.spans.get(name, 0.0)
                                  + (time.perf_counter_ns() - t0) * 1e-9)


def span(name: str):
    """A range named ``name`` in the profiler's trace, its time booked on
    the current record; the shared null context when there is none."""
    record = _current
    return _NULL if record is None else _timed(record, name)


def count(name: str, n: int) -> None:
    """Add ``n`` to the current record's count ``name``."""
    record = _current
    if record is not None:
        record.counts[name] = record.counts.get(name, 0) + int(n)
