"""Typed metrics plane: counters, gauges, mergeable exponential histograms.

The paper's profiler is *always on* and fleet-merged (§3: per-host counters
are only representative once aggregated); the repo's telemetry before this
module was the opposite — ad-hoc ``stats()`` dicts recomputed at read time,
with no labels, no time dimension, and no merge law. This registry is the
unified substrate those dicts migrate onto:

* **Counter / Gauge** — plain host ints/floats. Counters are monotone sums,
  so a fleet ``merge`` over per-replica registries is exact (bit-identical
  to the legacy ``fleet_stats`` sums — the acceptance oracle in
  tests/test_obs.py).
* **Histogram** — exponential buckets (``growth`` per bucket, dict-sparse),
  mergeable by bucket-wise addition. Quantiles are deterministic bucket
  upper bounds, so a merged fleet histogram reports the same p99 as the
  union of its inputs — the property ``np.percentile`` over raw sample
  lists never had, and the reason tenant queue-wait p50/p99 moved here.
* **Labels** — every instrument key is (name, sorted label items); the
  conventional dimensions are ``tenant=`` and ``replica=``. A registry may
  carry ``const_labels`` (e.g. ``replica="3"``) applied to every key at
  snapshot/merge time, so engines created before their host rid is known
  still export fully-labeled series.

Device-side series (near/far hits, moved bytes, dispatches, syncs) enter a
registry ONLY from ``drain_counters()`` deltas at the serving engine's
drain boundaries — the registry never adds a dispatch or a host sync to the
decode hot path, and the drain-cadence invariant (books bit-identical
at any cadence) extends to every metric here because deltas are pure sums.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Tuple

Key = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, labels: Dict[str, str]) -> Key:
    return (name, tuple(sorted((str(k), str(v)) for k, v in labels.items())))


class Counter:
    """Monotone sum. ``inc`` is one int add — hot-path safe."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1):
        self.value += n


class Gauge:
    """Last-write-wins level; merged by summing (capacities, queue depths)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float):
        self.value = float(v)


class Histogram:
    """Exponential-bucket histogram: sparse, mergeable, deterministic.

    Bucket ``i`` covers ``(growth**(i-1), growth**i]``; values <= 0 land in
    a dedicated zero bucket. ``quantile`` returns the upper bound of the
    bucket holding the rank-``ceil(q*count)`` sample — a value the true
    quantile never exceeds by more than one bucket width (relative error
    <= growth - 1), identical whether computed before or after ``merge``.
    """

    __slots__ = ("growth", "_log_g", "zero", "buckets", "count", "sum", "max")

    def __init__(self, growth: float = 2.0 ** 0.125):
        assert growth > 1.0
        self.growth = float(growth)
        self._log_g = math.log(self.growth)
        self.zero = 0
        self.buckets: Dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.max = 0.0

    def record(self, v: float, n: int = 1):
        v = float(v)
        self.count += n
        self.sum += v * n
        if v > self.max:
            self.max = v
        if v <= 0.0:
            self.zero += n
            return
        # smallest i with growth**i >= v (guard the exact-power boundary)
        i = math.ceil(math.log(v) / self._log_g - 1e-12)
        self.buckets[i] = self.buckets.get(i, 0) + n

    def merge(self, other: "Histogram"):
        assert abs(other.growth - self.growth) < 1e-12, "bucket grids differ"
        self.zero += other.zero
        self.count += other.count
        self.sum += other.sum
        self.max = max(self.max, other.max)
        for i, n in other.buckets.items():
            self.buckets[i] = self.buckets.get(i, 0) + n

    def quantile(self, q: float) -> Optional[float]:
        """Rank-``ceil(q*count)`` bucket upper bound, or ``None`` when the
        histogram is empty. An empty series has NO quantile — reporting 0.0
        made a tenant with no samples indistinguishable from one with
        genuinely zero latency, so consumers must omit (not zero-fill) the
        statistic when this returns None."""
        if self.count == 0:
            return None
        rank = min(self.count, max(1, math.ceil(q * self.count)))
        if rank <= self.zero:
            return 0.0
        cum = self.zero
        for i in sorted(self.buckets):
            cum += self.buckets[i]
            if cum >= rank:
                return self.growth ** i
        return self.max  # unreachable unless float drift; cap at observed max

    @property
    def mean(self) -> float:
        return self.sum / max(self.count, 1)

    def state(self) -> dict:
        """JSON-serializable snapshot (the metrics-JSONL export format).
        ``p50``/``p99`` appear only when there are samples — an empty
        histogram exports its (zero) count, not a fabricated latency."""
        out = {
            "type": "histogram",
            "growth": self.growth,
            "zero": self.zero,
            "count": self.count,
            "sum": self.sum,
            "max": self.max,
            "buckets": {str(i): n for i, n in sorted(self.buckets.items())},
        }
        if self.count:
            out["p50"] = self.quantile(0.50)
            out["p99"] = self.quantile(0.99)
        return out


@dataclasses.dataclass
class MetricSnapshot:
    """Frozen registry state, detached from live instruments — what a
    ReplicaProfile carries across retirement and what exporters serialize."""

    counters: Dict[Key, int]
    gauges: Dict[Key, float]
    histograms: Dict[Key, Histogram]  # deep copies, safe to merge into

    def flat(self) -> dict:
        """One JSON-ready dict: ``name{k=v,...}`` -> value/state."""

        def fmt(key: Key):
            name, labels = key
            if not labels:
                return name
            return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"

        out: dict = {fmt(k): v for k, v in sorted(self.counters.items())}
        out.update({fmt(k): v for k, v in sorted(self.gauges.items())})
        out.update({fmt(k): h.state() for k, h in sorted(self.histograms.items())})
        return out


class MetricsRegistry:
    """Instrument factory + store. One per engine/replica and one per
    router; the fleet view is ``merge_snapshots`` over all of them (routed
    through the aggregator path like every other per-host export).
    """

    def __init__(self, const_labels: Optional[Dict[str, str]] = None):
        self.const_labels: Dict[str, str] = dict(const_labels or {})
        self._counters: Dict[Key, Counter] = {}
        self._gauges: Dict[Key, Gauge] = {}
        self._histograms: Dict[Key, Histogram] = {}

    # ------------------------------------------------------------------
    def counter(self, name: str, **labels) -> Counter:
        k = _key(name, labels)
        c = self._counters.get(k)
        if c is None:
            c = self._counters[k] = Counter()
        return c

    def gauge(self, name: str, **labels) -> Gauge:
        k = _key(name, labels)
        g = self._gauges.get(k)
        if g is None:
            g = self._gauges[k] = Gauge()
        return g

    def histogram(self, name: str, growth: float = 2.0 ** 0.125, **labels) -> Histogram:
        k = _key(name, labels)
        h = self._histograms.get(k)
        if h is None:
            h = self._histograms[k] = Histogram(growth)
        return h

    # ------------------------------------------------------------------
    def _with_const(self, key: Key) -> Key:
        if not self.const_labels:
            return key
        name, labels = key
        merged = dict(labels)
        for k, v in self.const_labels.items():
            merged.setdefault(str(k), str(v))
        return (name, tuple(sorted(merged.items())))

    def snapshot(self) -> MetricSnapshot:
        """Freeze current state with const labels applied (deep copies)."""
        hists = {}
        for k, h in self._histograms.items():
            c = Histogram(h.growth)
            c.merge(h)
            hists[self._with_const(k)] = c
        return MetricSnapshot(
            counters={self._with_const(k): c.value for k, c in self._counters.items()},
            gauges={self._with_const(k): g.value for k, g in self._gauges.items()},
            histograms=hists,
        )

    def total(self, name: str) -> int:
        """Sum of a counter across all label sets — the legacy-dict view."""
        return sum(c.value for (n, _), c in self._counters.items() if n == name)


def merge_snapshots(snaps: Iterable[MetricSnapshot]) -> MetricSnapshot:
    """Fleet merge: counters/gauges sum, histograms add bucket-wise.

    Exact by construction — every value is an int sum or a bucket-count
    sum, so merging per-replica registries reproduces the legacy
    ``fleet_stats`` totals bit-identically (the acceptance criterion).
    """
    out = MetricSnapshot({}, {}, {})
    for s in snaps:
        for k, v in s.counters.items():
            out.counters[k] = out.counters.get(k, 0) + v
        for k, v in s.gauges.items():
            out.gauges[k] = out.gauges.get(k, 0.0) + v
        for k, h in s.histograms.items():
            dst = out.histograms.get(k)
            if dst is None:
                dst = out.histograms[k] = Histogram(h.growth)
            dst.merge(h)
    return out


def sum_counters(snap: MetricSnapshot, name: str) -> int:
    """Collapse a counter's label dimensions — e.g. fleet tokens_decoded."""
    return sum(v for (n, _), v in snap.counters.items() if n == name)


def merged_histogram(snap: MetricSnapshot, name: str) -> Optional[Histogram]:
    """Collapse a histogram's label dimensions into one distribution."""
    hs: List[Histogram] = [h for (n, _), h in snap.histograms.items() if n == name]
    if not hs:
        return None
    out = Histogram(hs[0].growth)
    for h in hs:
        out.merge(h)
    return out


def prefetch_report(snap: MetricSnapshot) -> dict:
    """Paper-formula prefetcher scores from the registry's prefetch books.

    Derives accuracy / coverage / wasted bytes from the drain-synced
    counters (``prefetch_issued_pages`` etc.) instead of reaching into the
    live engine — so the same report works on a merged fleet snapshot or a
    retired replica's frozen profile, and inherits the drain-cadence
    invariant: identical numbers at any drain schedule. Ratios use the
    exact formulas of ``core.prefetch.PrefetchStats``.
    """
    issued = sum_counters(snap, "prefetch_issued_pages")
    used = sum_counters(snap, "prefetch_used_pages")
    unused = sum_counters(snap, "prefetch_unused_evicted_pages")
    demand = sum_counters(snap, "prefetch_demand_fetches")
    denom = issued + demand - unused
    return {
        "issued_pages": issued,
        "used_pages": used,
        "unused_evicted_pages": unused,
        "demand_fetches": demand,
        "promoted_pages": sum_counters(snap, "prefetch_promoted_pages"),
        "wasted_bytes": sum_counters(snap, "prefetch_wasted_bytes"),
        "accuracy": 1.0 - unused / issued if issued else 1.0,
        "coverage": (issued - unused) / denom if denom > 0 else 0.0,
    }
