"""WordCount, as the plain reference replays it: each tuple emits its key's
count over the current interval and the ``window`` intervals before it; a
key's last emit is its output; cost 1 a tuple; state ``bytes_per_entry``
per (key, interval) slot held.

``PROGRAM`` names the program's operator this one stands beside (a class of
``repro_torch.streams.operators``, built with the configuration's
``operator_args``); ``SPANS`` marks its closed forms in a traced run.
"""

import numpy as np

PROGRAM = "WordCount"
SPANS = {"engine.closed_forms":
         "repro_torch.streams.operators:WordCount.device_finish"}
DEFAULTS = {"bytes_per_entry": 16.0}


def interval(m: np.ndarray, c0: np.ndarray, args: dict):
    """For the keys seen in an interval, ``m`` tuples each over ``c0``
    held before it: ``(cost, output, emitted)``."""
    emitted = float(np.dot(m, c0) + np.dot(m, m + 1) / 2.0)
    return m.astype(np.float64), c0 + m, emitted


def memory(n_slots: np.ndarray, held: np.ndarray, args: dict) -> np.ndarray:
    """Bytes a key holds: one entry per slot of the window it appears in."""
    return float(args["bytes_per_entry"]) * n_slots.astype(np.float64)
