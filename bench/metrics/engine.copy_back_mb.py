"""engine.copy_back_mb: the program's count ``d2h_bytes`` (every tensor the
interval copies from the card to the host: the ring step's outputs, the
dense F(k) table after a table change, an eviction's held totals), in MB
(1e6 bytes) per interval of the window. Read from the reports' trace
records."""

from bench import program_trace


def read(run):
    return program_trace.count(run, "d2h_bytes", 1e-6)
