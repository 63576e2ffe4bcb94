"""routing_lookup.roofline: the routing kernel's share of its roofline, in
%: the least time of its launches in the window (their bytes, as the
benchmark's yardstick reckons them from each call's shapes, over the card's
memory peak) over their time on the card, by the kernel's name in the
profiler's trace. Nothing to read where the window launched no kernel."""

from bench import yardstick

KERNEL = "routing_lookup_kernel"


def _shapes(args, kwargs, out):
    keys, table = args[0], args[1]
    return {"keys": int(keys.numel()), "buckets": int(table.buckets.shape[0]),
            "cuda": keys.device.type == "cuda"}


SPANS = {"routing_lookup": ("repro_torch.streams.device:route_keys",
                            _shapes)}


def read(run):
    if run.trace is None:
        return None
    calls = [c.info for c in run.spans.get("routing_lookup", [])
             if c.info["cuda"] and c.info["keys"]]
    kernels = run.trace.kernels(KERNEL)
    if not kernels:
        return None
    if len(kernels) != len(calls):
        run.notes.append(f"routing_lookup.roofline: {len(kernels)} kernels "
                         f"in the trace against {len(calls)} calls: not read")
        return None
    least = sum(yardstick.least_seconds(
        yardstick.routing_lookup_bytes(c["keys"], c["buckets"]))
        for c in calls)
    took = sum(dur for _, _, _, dur in kernels) / 1e6
    run.notes.append(f"routing_lookup.roofline: {len(calls)} launches, "
                     f"least {least * 1e3:.6f} ms, on the card "
                     f"{took * 1e3:.6f} ms")
    return 100.0 * least / took
