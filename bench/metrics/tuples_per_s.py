"""tuples_per_s: every tuple of the intervals the stage completed in the
measured window, over the window's whole wall time (which ends at a
completed interval). Host clock; the card synchronised at both ends."""


def read(run):
    if not run.intervals or run.window_s <= 0:
        return None
    return run.tuples / run.window_s
