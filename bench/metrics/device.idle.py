"""device.idle: the share of the traced window, in %, in which no kernel,
copy or fill ran on the card: 1 - (the union of the device's activity in
the profiler's trace) / (the window's length in that trace)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
