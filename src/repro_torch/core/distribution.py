"""Hotness-distribution math (Fig. 9 / Fig. 18 analytics).

Everything operates on a per-block access-count vector (the profiler's
output): CDFs, hot-set extraction, Zipf fits, and the interval-stability
check that justifies tiering (paper: "a similar memory bandwidth profile for
different measurement intervals ... supports memory bandwidth tiering").
"""
from __future__ import annotations

import numpy as np


def bandwidth_cdf(counts: np.ndarray):
    """counts: (n_blocks,) access counts.

    Returns (capacity_frac, traffic_frac): traffic_frac[i] = fraction of all
    accesses served by the hottest capacity_frac[i] of blocks.
    """
    counts = np.asarray(counts, dtype=np.float64)
    n = counts.size
    order = np.argsort(-counts)
    sorted_c = counts[order]
    total = max(sorted_c.sum(), 1.0)
    traffic = np.cumsum(sorted_c) / total
    capacity = np.arange(1, n + 1) / n
    return capacity, traffic


def hot_fraction(counts: np.ndarray, capacity_frac: float) -> float:
    """Traffic fraction served by the hottest ``capacity_frac`` of blocks."""
    cap, tra = bandwidth_cdf(counts)
    k = max(1, int(np.ceil(capacity_frac * counts.size)))
    return float(tra[k - 1])


def capacity_for_traffic(counts: np.ndarray, traffic_frac: float) -> float:
    """Smallest capacity fraction serving >= ``traffic_frac`` of accesses
    (the paper's '90%-tile bandwidth is contributed by <10% of capacity')."""
    cap, tra = bandwidth_cdf(counts)
    idx = int(np.searchsorted(tra, traffic_frac))
    idx = min(idx, counts.size - 1)
    return float(cap[idx])


def hot_set(counts: np.ndarray, capacity_frac: float) -> np.ndarray:
    """Block ids of the hottest ``capacity_frac`` of blocks."""
    k = max(1, int(np.ceil(capacity_frac * counts.size)))
    return np.argsort(-np.asarray(counts))[:k]


def zipf_alpha(counts: np.ndarray) -> float:
    """Least-squares Zipf exponent over the non-zero ranked counts."""
    c = np.sort(np.asarray(counts, dtype=np.float64))[::-1]
    c = c[c > 0]
    if c.size < 3:
        return 0.0
    ranks = np.arange(1, c.size + 1)
    slope, _ = np.polyfit(np.log(ranks), np.log(c), 1)
    return float(-slope)


def interval_stability(window_counts: list[np.ndarray], capacity_frac: float = 0.1) -> dict:
    """Max deviation of hot_fraction across measurement windows (Fig. 18).

    Small deviation == the bandwidth distribution is stable over time ==
    tiering placement decisions stay valid between migrations.
    """
    fracs = [hot_fraction(w, capacity_frac) for w in window_counts if np.sum(w) > 0]
    if not fracs:
        return {"mean": 0.0, "max_dev": 0.0, "fracs": []}
    mean = float(np.mean(fracs))
    return {"mean": mean, "max_dev": float(np.max(np.abs(np.array(fracs) - mean))), "fracs": fracs}


def pearson(a: np.ndarray, b: np.ndarray) -> float:
    """Pearson correlation between two access-count vectors (Table 2)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    sa, sb = a.std(), b.std()
    if sa == 0 or sb == 0:
        return 0.0
    return float(((a - a.mean()) * (b - b.mean())).mean() / (sa * sb))
