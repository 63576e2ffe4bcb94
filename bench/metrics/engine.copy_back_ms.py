"""engine.copy_back_ms: the program's span ``stage.copy_back`` (the copies
of the ring step's outputs to the host, the wait for the step on the card
included; an eviction-only interval's held totals), in ms per interval of
the window. Read from the reports' trace records."""

from bench import program_trace


def read(run):
    return program_trace.span_ms(run, "stage.copy_back")
