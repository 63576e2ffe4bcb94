"""What the per-layer metrics read of the program's own trace: the record
that each report of the window carries (``IntervalReport.trace``: span
seconds and counts by name, booked by the program while the profiler
records). A program without such a record, or the control's reports, give
nothing to read."""


def per_interval(run, read):
    """``read(record)`` summed over the window's reports that carry a
    record, over the window's reports; None where none carries one."""
    records = [getattr(r, "trace", None) for r in run.reports]
    if all(t is None for t in records):
        return None
    return sum(read(t) for t in records if t is not None) / len(records)


def span_ms(run, *names):
    """The spans ``names`` together, in ms per interval of the window."""
    return per_interval(
        run, lambda t: 1e3 * sum(t.spans.get(n, 0.0) for n in names))


def count(run, name, scale=1.0):
    """The count ``name`` times ``scale``, per interval of the window."""
    return per_interval(run, lambda t: scale * t.counts.get(name, 0))
