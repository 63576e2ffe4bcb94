"""controller.plan_ms: the planner's own time (``plan_time_s``, its
``perf_counter``) summed over the window's rebalances, per interval of the
window. The spans around the controller's round, its trigger's theta and
the migration it hands the backend only mark the host's time in the trace,
for the breakdown's idle gaps (the round's own time there is the plan's)."""

SPANS = {"controller": "repro_torch.core.controller:"
                       "RebalanceController.on_interval",
         "controller.trigger": "repro_torch.core.balancer.metrics:theta_for",
         "controller.migrate": "repro_torch.streams.backends:"
                               "DeviceBackend.migrate"}


def read(run):
    if not run.reports:
        return None
    return 1e3 * sum(r.plan_time_s for r in run.reports) / len(run.reports)
