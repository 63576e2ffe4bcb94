"""engine.mirrors_ms: the program's spans ``stage.mirrors`` (task cost,
the ownership and S(k, w) host mirrors over the key domain) and
``stage.stats`` (the stat universe and the ``KeyStats``), together, in ms
per interval of the window. Read from the reports' trace records."""

from bench import program_trace


def read(run):
    return program_trace.span_ms(run, "stage.mirrors", "stage.stats")
