"""HLHE value discretization with greedy sign balancing (paper Sec. IV-B).

Step 1 (representative values, half-linear-half-exponential): given degree
R = 2^r and max value M (values normalized so min >= 1),
  linear part      y = s*R, (s-1)*R, ..., R          with s = floor(M / R)
  exponential part y = R/2, R/4, ..., 2, 1
Step 2 (greedy): process values in non-increasing order; x in [y_j, y_{j-1})
may round to either bracket end; choose the larger iff the accumulated
deviation sum(x - phi(x)) so far is positive (cancels over-counting).

The paper's Fig. 6 worked example reaches |delta| = 0; the greedy rule as
stated reaches |delta| <= R in general (Theorem 3's "~0"), which the property
tests assert: |delta| stays bounded by the largest bracket gap independent of
the number of values.
"""

from __future__ import annotations

import numpy as np


def hlhe_representatives(max_value: float, r: int) -> np.ndarray:
    """Strictly decreasing representative values y_1 > y_2 > ... > y_m >= 1."""
    if r < 0:
        raise ValueError("r must be >= 0")
    R = 2 ** r
    s = max(1, int(np.floor(max_value / R)))
    linear = [float((s - i) * R) for i in range(s)]          # s*R ... R
    expo = [float(2 ** (r - t)) for t in range(1, r + 1)]    # R/2 ... 1
    ys = linear + expo
    # guard: strictly decreasing, unique (R=1 -> expo empty, linear only)
    out = []
    for y in ys:
        if not out or y < out[-1]:
            out.append(y)
    return np.asarray(out, dtype=np.float64)


def discretize(values: np.ndarray, r: int) -> np.ndarray:
    """phi(x) per the greedy sign-balancing rule. Preserves input order."""
    values = np.asarray(values, dtype=np.float64)
    if values.size == 0:
        return values.copy()
    if np.any(values < 1.0):
        raise ValueError("values must be normalized to >= 1")
    ys = hlhe_representatives(float(values.max()), r)
    order = np.argsort(-values, kind="stable")               # non-increasing
    sorted_vals = values[order]
    # ys is decreasing; bracket j such that ys[j-1] > x >= ys[j]: on the
    # increasing array -ys that is the first index with ys[j] <= x.
    # Vectorized once — the greedy sign choice below is inherently sequential.
    js = np.searchsorted(-ys, -sorted_vals, side="left")
    js = np.clip(js, 1, len(ys) - 1)
    hi_arr = ys[js - 1].tolist()
    lo_arr = ys[js].tolist()
    cap = float(ys[0])
    xs = sorted_vals.tolist()
    out_sorted = np.empty_like(sorted_vals)
    acc = 0.0                                                # sum(x - phi(x))
    for i, x in enumerate(xs):
        if x >= cap:
            phi = cap
        else:
            phi = hi_arr[i] if acc > 0 else lo_arr[i]
        acc += x - phi
        out_sorted[i] = phi
    out = np.empty_like(values)
    out[order] = out_sorted
    return out


def total_deviation(values: np.ndarray, discretized: np.ndarray) -> float:
    """|delta| = |sum(x - phi(x))| (the paper's accumulated-error metric)."""
    return float(abs(np.sum(np.asarray(values) - np.asarray(discretized))))
