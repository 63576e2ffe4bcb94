"""engine.outputs_ms: the program's span ``stage.outputs`` (the stage's
``outputs`` update over the interval's keys and its emitted sum), in ms
per interval of the window. Read from the reports' trace records."""

from bench import program_trace


def read(run):
    return program_trace.span_ms(run, "stage.outputs")
