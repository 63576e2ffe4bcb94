"""engine.interval_ms_p90: the 90th percentile of the window's interval
times, each the host clock around one ``KeyedStage.process_interval_arrays``
call with the card synchronised after it. The sample count goes on an
earlier line of standard error."""

import statistics


def read(run):
    ms = run.interval_ms
    if len(ms) < 2:
        return None
    p90 = statistics.quantiles(ms, n=10, method="inclusive")[8]
    run.notes.append(f"engine.interval_ms_p90: {len(ms)} intervals, "
                     f"median {statistics.median(ms):.4f} ms, "
                     f"p90 {p90:.4f} ms")
    return p90
