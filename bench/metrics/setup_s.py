"""setup_s: from the start of the run's process to the opening of the
measured window: imports, the card's start, the kernel's library (built
only where the checkout has none yet), the stage, the traffic cycle drawn
from the seed and the warm-up intervals. Host clock."""


def read(run):
    return run.setup_s
