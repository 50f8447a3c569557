"""Statistics over all requests of a window (never over chunks)."""

from __future__ import annotations

import math

import numpy as np


def percentile(values, q: float) -> float:
    """Nearest-rank percentile of all values (inf for a failed request
    ranks above every answer)."""
    v = np.sort(np.asarray(values, float))
    if v.size == 0:
        return math.nan
    return float(v[max(0, math.ceil(q / 100.0 * v.size) - 1)])


def completed_rate(count: float, t0: float, done) -> float:
    """`count` units of work over the time from t0 until the last of the
    window's calls answered."""
    done = np.asarray(done, float)
    done = done[np.isfinite(done)]
    if done.size == 0 or count <= 0:
        return 0.0
    return float(count / (done.max() - t0))


def latencies_from_due(rec: dict) -> np.ndarray:
    """Seconds from each request's due time to its answer; inf for one
    that failed or never answered."""
    lat = rec["done"] - rec["due"]
    return np.where(rec["ok"] & np.isfinite(lat), lat, np.inf)
