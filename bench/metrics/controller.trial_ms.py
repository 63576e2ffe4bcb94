"""controller.trial_ms: the program's span ``plan.trial`` (each pass of
Mixed's trial loop: the Phase-I delta, the LLFD trial, its table-size and
balance checks), in ms per interval of the window; beside
``controller.plan_ms`` it splits the plan. Read from the reports' trace
records, each booked on the interval whose round ran the plan."""

from bench import program_trace


def read(run):
    return program_trace.span_ms(run, "plan.trial")
