"""route.ms: the dense route, per interval of the window: the spans around
``DeviceStateFleet.route_dense`` (the table's build and upload and the
routing kernel) and ``DeviceStateFleet.dest_host_dense`` (the copy back),
synchronised. The stage routes once per table version, so an interval that
keeps its table adds 0."""

SPANS = {"route_dense": "repro_torch.streams.device:"
                        "DeviceStateFleet.route_dense",
         "route_copy": "repro_torch.streams.device:"
                       "DeviceStateFleet.dest_host_dense"}


def read(run):
    if not run.intervals:
        return None
    calls = run.spans.get("route_dense", []) + run.spans.get("route_copy", [])
    return sum(c.ms for c in calls) / run.intervals
