"""Online fleet re-tiering: plan on the aggregate, push to every host.

The paper's tiering decision (§5, Table 5) is made from *fleet* behavior —
"few pages serve most bandwidth" is a property of the service, not of one
host's recent window. The AutoTierer periodically re-runs core/tiering.plan
on the aggregated fleet histogram and pushes the resulting near-tier page
set to every replica (which suppresses their local TPP loops), so placement
is driven by the representative profile instead of each engine's noisy
local view. Under a stationary workload the pushed plan converges: the
Jaccard overlap of successive near-sets approaches 1.

Epochs are keyed on *virtual time*, not fleet-step counts: the event-driven
fleet has no global tick, and an elastic fleet has no fixed replica set.
The hook receives the scheduler's clock and re-plans every ``epoch_steps``
units of virtual time (in lockstep mode with nominal speeds one unit == one
fleet step, so the legacy cadence is unchanged). Retired replicas keep
contributing through ``extra_profiles`` — a drained host's history is part
of the service's behavior even after the host is gone — and a freshly added
replica with no traffic yet contributes zeros, never NaNs.

Multi-tenant: the plan is still made from the COMBINED histogram — the near
tier is one physical resource — but each epoch also reports the fraction of
every tenant's accesses the pushed near set would serve. A skew-heavy
tenant crowding the top-k pushes its neighbors' planned near-hit down;
that per-tenant spread is the co-location interference signal the
tenant_interference benchmark measures.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import tiering
from repro_torch.core.hw import HBM_BW, HOST_LINK_BW, TierSpec
from repro_torch.fleet import aggregator
from repro_torch.fleet.replica import Replica, ReplicaProfile


def _fleet_specs(near_frac: float) -> tuple:
    return (
        TierSpec("hbm", near_frac, HBM_BW, 1.0, 8.0),
        TierSpec("host-dram", 1.0 - near_frac, HOST_LINK_BW, 6.0, 1.0),
    )


@dataclasses.dataclass
class TierEpoch:
    fleet_step: int
    near_ids: np.ndarray
    near_hit_frac: float  # planned fraction of accesses served near
    migrated_pages: int  # placement changes this push cost, fleet-wide
    overlap_prev: float  # Jaccard vs previous epoch's near set
    # planned near-served fraction per tenant under the SAME shared near set
    tenant_near_frac: Dict[str, float] = dataclasses.field(default_factory=dict)
    vtime: float = 0.0  # virtual time this epoch was planned at
    n_replicas: int = 0  # live replica-set size at plan time (elasticity)
    # bytes the push actually moved through the hosts' device tier stores
    # (promote dequants + demote quants); 0 when hosts run host-accounted
    device_moved_bytes: int = 0
    # fleet-wide dispatch/sync budget at plan time: CUMULATIVE tiered-gather
    # kernel launches and counter-plane host syncs across the live replica
    # set (snapshots, not per-epoch deltas like device_moved_bytes — diff
    # consecutive epochs for a rate; retired hosts are excluded). Epochs
    # read DRAINED device counters — the profile export that feeds the
    # plan is a drain boundary — so these never lag the plan's inputs
    device_dispatches: int = 0
    device_host_syncs: int = 0
    # fleet-trained prefetch successor tables pushed alongside the near
    # set, TENANT-PARTITIONED ({tenant: {block: (succ, ...)}}): the
    # trace-driven prefetcher's fleet plane — sequences learned on any host
    # prefetch for all of them, but only within their own tenant's
    # partition, so one tenant's template chains cannot evict another
    # tenant's pending prefetches on the hosts the push lands on
    prefetch_table: Dict[str, Dict[int, tuple]] = dataclasses.field(
        default_factory=dict
    )
    # per-shard near-tier capacity of each sharded host at plan time
    # ({rid: (cap_shard0, cap_shard1, ...)}): a sharded replica's near tier
    # is the UNION of its shards' slices, and the planner's near set lands
    # on each shard restricted to the pages that shard owns — these are the
    # per-shard ceilings that restriction is guaranteed to fit under
    shard_near_capacity: Dict[int, tuple] = dataclasses.field(default_factory=dict)


class AutoTierer:
    def __init__(
        self,
        replicas: List[Replica],
        near_frac: float = 0.30,
        epoch_steps: int = 32,
        specs: Optional[tuple] = None,
    ):
        self.replicas = replicas
        self.near_frac = near_frac
        self.epoch_steps = epoch_steps
        self.specs = specs or _fleet_specs(near_frac)
        self.history: List[TierEpoch] = []
        # profiles of replicas retired by the elastic layer: their traffic
        # shaped the service's histogram, so the plan keeps seeing it
        self.extra_profiles: List[ReplicaProfile] = []
        self._last_epoch = 0.0
        # monotone plan sequence number, stamped on every push: engines
        # fence on it after a failover so a plan computed from pre-fault
        # profiles can never land on a host the fault machinery reset
        self.epoch_seq = 0

    # ------------------------------------------------------------------
    def __call__(self, now: float):
        """FleetRouter.on_step hook; ``now`` is fleet virtual time."""
        if now - self._last_epoch >= self.epoch_steps:
            # advance the boundary grid (even when there is no data yet) so
            # epochs stay aligned with the legacy fleet-step modulo cadence
            self._last_epoch += self.epoch_steps * math.floor(
                (now - self._last_epoch) / self.epoch_steps
            )
            self.step(now)

    def step(self, now: float = 0.0) -> Optional[TierEpoch]:
        profiles = aggregator.export_all(self.replicas) + list(self.extra_profiles)
        counts = aggregator.aggregate_counts(profiles)
        if counts.size == 0 or counts.sum() == 0:
            return None
        self.epoch_seq += 1
        p = tiering.plan(counts, self.specs)
        # the prefetch plane rides the placement epoch: one table trained
        # from every host's stream-tagged windows, pushed with the near set
        table = aggregator.train_fleet_successors(profiles)
        moved_before = sum(r.device_moved_bytes for r in self.replicas)
        migrated = sum(
            r.apply_placement(p.hot_blocks, epoch=self.epoch_seq)
            for r in self.replicas
        )
        if table:
            for r in self.replicas:
                r.load_successors(table)
        device_moved = sum(r.device_moved_bytes for r in self.replicas) - moved_before
        overlap = 0.0
        if self.history:
            prev = set(self.history[-1].near_ids.tolist())
            cur = set(p.hot_blocks.tolist())
            overlap = len(prev & cur) / max(len(prev | cur), 1)
        tenant_frac = {}
        for t, tc in aggregator.aggregate_tenant_counts(profiles).items():
            total = float(tc.sum())
            if tc.size == 0 or total <= 0.0:
                # a freshly added replica registers its tenant streams
                # before any traffic lands: report an explicit 0, never
                # divide into a zero histogram
                tenant_frac[t] = 0.0
                continue
            near = tc[p.hot_blocks[p.hot_blocks < tc.size]].sum()
            tenant_frac[t] = float(near / total)
        # live hosts only: extra_profiles are frozen snapshots of retired
        # hosts and would inflate the budget for the rest of the run
        live = profiles[: len(self.replicas)]
        dev = [pr.device_tiering for pr in live if pr.device_tiering]
        shard_caps = {
            pr.rid: tuple(pr.device_tiering["shard_near_capacity"])
            for pr in live
            if pr.device_tiering and "shard_near_capacity" in pr.device_tiering
        }
        epoch = TierEpoch(
            int(now),
            p.hot_blocks,
            p.hit_fracs[0],
            migrated,
            overlap,
            tenant_frac,
            vtime=float(now),
            n_replicas=len(self.replicas),
            device_moved_bytes=device_moved,
            device_dispatches=sum(d["dispatches"] for d in dev),
            device_host_syncs=sum(d["host_syncs"] for d in dev),
            prefetch_table=table,
            shard_near_capacity=shard_caps,
        )
        self.history.append(epoch)
        return epoch

    # ------------------------------------------------------------------
    def warm_near_ids(self) -> Optional[np.ndarray]:
        """Latest pushed near set — what a scaled-up replica warms from."""
        return self.history[-1].near_ids if self.history else None

    def warm_successors(self) -> Dict[str, Dict[int, tuple]]:
        """Latest fleet prefetch tables (tenant-partitioned) — a joining
        host predicts from its first step instead of cold-starting its own
        trace training."""
        return self.history[-1].prefetch_table if self.history else {}

    @property
    def converged(self) -> bool:
        """Plan is stable once consecutive near-sets mostly agree."""
        return len(self.history) >= 2 and self.history[-1].overlap_prev >= 0.8

    def convergence_trace(self) -> List[float]:
        return [e.overlap_prev for e in self.history]
