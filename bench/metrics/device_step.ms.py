"""device_step.ms: the span around ``DeviceStateFleet.interval_step`` (the
ring's step on the card), synchronised before and after, in ms per interval
of the window."""

SPANS = {"device_step": "repro_torch.streams.device:"
                        "DeviceStateFleet.interval_step"}


def read(run):
    calls = run.spans.get("device_step", [])
    if not calls or not run.intervals:
        return None
    return sum(c.ms for c in calls) / run.intervals
