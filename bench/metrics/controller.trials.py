"""controller.trials: the program's count ``plan_trials`` (the trials the
planner reports it ran, ``RebalanceResult.meta["trials"]``), per interval
of the window. Read from the reports' trace records."""

from bench import program_trace


def read(run):
    return program_trace.count(run, "plan_trials")
