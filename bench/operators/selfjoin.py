"""The windowed self-join, as the plain reference replays it: each tuple
probes every tuple of its key held in the window (the current interval's
earlier ones included) and emits the number of matches; its output is its
matches; cost 1 + ``probe_cost`` per probe; state ``bytes_per_tuple`` per
held tuple.

``PROGRAM`` names the program's operator this one stands beside (a class of
``repro_torch.streams.operators``, built with the configuration's
``operator_args``); ``SPANS`` marks its closed forms in a traced run.
"""

import numpy as np

PROGRAM = "WindowedSelfJoin"
SPANS = {"engine.closed_forms":
         "repro_torch.streams.operators:WindowedSelfJoin.device_finish"}
DEFAULTS = {"bytes_per_tuple": 32.0, "probe_cost": 0.01}


def interval(m: np.ndarray, c0: np.ndarray, args: dict):
    """For the keys seen in an interval, ``m`` tuples each over ``c0``
    held before it: ``(cost, output, emitted)``."""
    probes = m * c0 + m * (m - 1) / 2.0
    cost = m * 1.0 + float(args["probe_cost"]) * probes
    return cost, c0 + m - 1, float(probes.sum())


def memory(n_slots: np.ndarray, held: np.ndarray, args: dict) -> np.ndarray:
    """Bytes a key holds: every tuple of it in the window."""
    return float(args["bytes_per_tuple"]) * held.astype(np.float64)
