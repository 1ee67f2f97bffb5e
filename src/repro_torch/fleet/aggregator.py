"""Fleet-wide MemProf: stitch per-host windows into one representative view.

Two aggregations, mirroring the paper's two planes:

* **profiling** (§4, Fig. 6): per-page access counts are summed over the
  *logical* page-id space — every replica runs the same engine over the same
  id space, exactly the "same code on many cores/hosts" premise, so the sum
  is the fleet's hotness histogram and drives fleet/autotier.py.

* **tracing** (§6.2, Table 6): each host's short attach/detach MemTracer
  windows are interleaved by time into ONE trace. Physical pages on
  different hosts are different memory, so block ids are namespaced per
  replica before stitching. Validation replays the stitched trace through a
  CacheSim scaled to the fleet's total cache capacity and compares hit ratio
  and R:W mix against the live per-host counters (paper: errors <= ~5%).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import distribution
from repro_torch.core.memtrace import TraceWindow, validate_trace
from repro_torch.core.prefetch import train_tenant_successors
from repro_torch.fleet.replica import Replica, ReplicaProfile
from repro_torch.obs import MetricSnapshot, merge_snapshots

# per-replica stream-id namespace stride for fleet-pooled successor
# training: stream ids are engine seq ids (< 2**32 in any real run), so
# shifting by the rid keeps two hosts' streams from ever chaining together
_STREAM_STRIDE = 1 << 32


def export_all(replicas: List[Replica]) -> List[ReplicaProfile]:
    return [r.export_profile() for r in replicas]


def aggregate_metrics(profiles: List[ReplicaProfile]) -> MetricSnapshot:
    """Fleet metrics merge over exported profiles — same path as the
    hotness histogram: per-host state is only representative aggregated.

    Counters sum exactly (ints), histograms add bucket-wise, so the merged
    totals equal the legacy ``fleet_stats`` sums bit-for-bit while keeping
    tenant/replica label dimensions the legacy dicts flatten away.
    """
    return merge_snapshots([p.metrics for p in profiles if p.metrics is not None])


def aggregate_counts(profiles: List[ReplicaProfile]) -> np.ndarray:
    """Fleet hotness histogram over the shared logical page-id space.

    Robust to an elastic fleet's edge states: no profiles (all hosts
    retired mid-export) and freshly added hosts with all-zero counts.
    """
    n = max((p.counts.size for p in profiles), default=0)
    out = np.zeros(n, np.int64)
    for p in profiles:
        out[: p.counts.size] += p.counts
    return out


def aggregate_tenant_counts(profiles: List[ReplicaProfile]) -> Dict[str, np.ndarray]:
    """Per-tenant fleet histograms over the same logical page-id space.

    Summing the returned histograms over tenants reproduces
    ``aggregate_counts`` exactly: every engine access is recorded once in
    the combined "kv" stream and once in its tenant's "kv.<t>" stream.
    """
    n = max((p.counts.size for p in profiles), default=0)
    out: Dict[str, np.ndarray] = {}
    for p in profiles:
        for t, counts in p.tenant_counts.items():
            dst = out.setdefault(t, np.zeros(n, np.int64))
            dst[: counts.size] += counts
    return out


def stitch_fleet(profiles: List[ReplicaProfile], n_pages: Optional[int] = None) -> TraceWindow:
    """One representative fleet trace from many hosts' windows.

    Windows are ordered by (virtual time, rid), where a window that opened
    at engine step s on a host that joined the fleet at virtual time t0
    with per-step cost c happened at virtual time t0 + s*c — on a
    heterogeneous fleet a straggler's step index advances slower than its
    clock, and an elastically added host's step counter starts at 0 no
    matter when it joined, so interleaving by raw step index would place
    both hosts' windows too early. With nominal speeds and a founding
    (t0=0) replica set this degenerates to the lockstep (start_step, rid)
    round-robin interleave: contemporaneous windows stay contemporaneous,
    and each host's working set stays warm in the fleet-scaled cache just
    as it does in that host's own cache. Known approximation (identical in
    lockstep and event modes): an engine's step counter freezes while the
    host is idle, so windows after an idle gap compress toward the gap's
    start — harmless for replay because idle hosts record no accesses.
    ``n_pages`` (the per-host namespace stride) defaults to the widest
    host's page space.
    """
    if n_pages is None:
        n_pages = max((p.n_pages for p in profiles), default=0)
    tagged = []
    for p in profiles:
        for w in p.windows:
            tagged.append((p.clock_offset + w.start_step * p.step_cost, p.rid, w))
    tagged.sort(key=lambda t: (t[0], t[1]))
    if not tagged:
        return TraceWindow(
            0, np.zeros(0, np.int64), np.zeros(0, bool), np.zeros(0, np.int64)
        )
    blocks = np.concatenate([w.blocks + rid * n_pages for _, rid, w in tagged])
    writes = np.concatenate([w.is_write for _, _, w in tagged])
    streams = np.concatenate(
        [
            (
                w.stream
                if w.stream is not None
                else np.zeros(w.blocks.size, np.int64)
            )
            + rid * _STREAM_STRIDE
            for _, rid, w in tagged
        ]
    )
    return TraceWindow(tagged[0][2].start_step, blocks, writes, streams)


def train_fleet_successors(
    profiles: List[ReplicaProfile],
    min_count: int = 2,
    min_frac: float = 0.3,
    max_successors: int = 2,
) -> Dict[str, Dict[int, tuple]]:
    """Train TENANT-PARTITIONED successor tables from every host's windows:
    ``{tenant: {block: (succ, ...)}}``.

    This is the paper's point in acting form: the fleet tracing tool
    exists to drive better prefetchers. Blocks stay in the shared LOGICAL
    page-id space — the same "same code on many hosts" premise that lets
    ``aggregate_counts`` sum histograms lets transitions observed on any
    host count as evidence for all of them — while stream ids are
    namespaced per replica, so two hosts' request streams never chain into
    each other (that would re-create the interleaving contamination the
    per-stream model exists to kill). Pooling windows and retraining beats
    merging the per-host ``ReplicaProfile.successors`` tables: counts from
    different hosts reinforce each other through the confidence gates.

    Partitioning rides each profile's ``stream_tenants`` map (seq id ->
    tenant, rid-namespaced here to match the pooled streams): one tenant's
    template chains train ONLY that tenant's table, so a pushed fleet table
    can never flood a neighbor tenant's pending prefetches out of the
    partitioned prefetch buffer. Streams with no tenant mapping (legacy
    profiles) train the default ``""`` partition.
    """
    tagged = []
    stream_tenants: Dict[int, str] = {}
    for p in profiles:
        for sid, t in getattr(p, "stream_tenants", {}).items():
            stream_tenants[int(sid) + p.rid * _STREAM_STRIDE] = t
        for w in p.windows:
            s = (
                w.stream
                if w.stream is not None
                else np.zeros(w.blocks.size, np.int64)
            )
            tagged.append(
                TraceWindow(w.start_step, w.blocks, w.is_write, s + p.rid * _STREAM_STRIDE)
            )
    return train_tenant_successors(
        tagged, stream_tenants,
        min_count=min_count, min_frac=min_frac, max_successors=max_successors,
    )


def live_fleet_counters(profiles: List[ReplicaProfile]) -> dict:
    """Ground truth: access-weighted live hit ratio + aggregate R:W."""
    acc = sum(p.live_accesses for p in profiles)
    hit = sum(p.live_hit_ratio * p.live_accesses for p in profiles) / max(acc, 1)
    reads = sum(p.reads for p in profiles)
    writes = sum(p.writes for p in profiles)
    return {"hit_ratio": hit, "rw_ratio": reads / max(writes, 1), "accesses": acc}


def validate_fleet(
    profiles: List[ReplicaProfile],
    n_pages: Optional[int] = None,
    capacity_per_replica: Optional[int] = None,
) -> dict:
    """Table 6 at fleet scale: stitched-trace replay vs live counters.

    The namespace stride and sim capacity default to what the profiles
    themselves report (page-space width, live-cache size), so the
    validation can't silently drift from the fleet's actual geometry.
    ``rw_ratio_error_pct`` is signed, as in core/memtrace.validate_trace.
    """
    trace = stitch_fleet(profiles, n_pages)
    live = live_fleet_counters(profiles)
    if capacity_per_replica is None:
        capacity_per_replica = max((p.live_capacity for p in profiles), default=1)
    res = validate_trace(
        trace, live["hit_ratio"], live["rw_ratio"],
        capacity_blocks=capacity_per_replica * len(profiles),
    )
    res["trace_len"] = int(trace.blocks.size)
    return res


def fleet_report(profiles: List[ReplicaProfile], capacity_fracs=(0.05, 0.1, 0.25)) -> dict:
    """The MemProf report over the aggregated fleet histogram (Fig. 9/18).

    ``tenants`` carries the same hotness profile per tenant plus the
    access-weighted near-tier hit rate each tenant realized — the combined
    view drives tiering, the per-tenant views expose who wins and who pays
    on the shared far tier.
    """
    counts = aggregate_counts(profiles)
    tenants = {}
    for t, tc in aggregate_tenant_counts(profiles).items():
        weights = [
            (p.tenant_near_hit.get(t, 0.0), float(p.tenant_counts.get(t, np.zeros(0)).sum()))
            for p in profiles
        ]
        wsum = sum(w for _, w in weights)
        tenants[t] = {
            "total_accesses": int(tc.sum()),
            "hot": {f: distribution.hot_fraction(tc, f) for f in capacity_fracs},
            "zipf_alpha": distribution.zipf_alpha(tc),
            "near_hit_rate": sum(h * w for h, w in weights) / max(wsum, 1.0),
        }
    return {
        "total_accesses": int(counts.sum()),
        "active_frac": float((counts > 0).mean()),
        "hot": {f: distribution.hot_fraction(counts, f) for f in capacity_fracs},
        "capacity_for_90pct": distribution.capacity_for_traffic(counts, 0.9),
        "zipf_alpha": distribution.zipf_alpha(counts),
        "near_hit_rate": float(
            np.mean([p.near_hit_rate for p in profiles]) if profiles else 0.0
        ),
        "tenants": tenants,
    }
