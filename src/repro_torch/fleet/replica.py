"""One serving host in the fleet: a ServingEngine plus its export surface.

The paper profiles the *same code running on many hosts*; the fleet layer's
unit of aggregation is therefore one engine with (a) live ground-truth
counters (a CacheSim fed every block access, the "production counters" of
Table 6) and (b) the windowed MemTracer / AccessProfiler state the
aggregator stitches into one representative fleet view (§6.2).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.memtrace import CacheSim, TraceWindow
from repro_torch.core.prefetch import train_successors
from repro_torch.data.requests import Request
from repro_torch.obs import MetricSnapshot
from repro_torch.runtime.serving import EngineConfig, ServingEngine


@dataclasses.dataclass
class ReplicaProfile:
    """Per-host MemProf export consumed by fleet/aggregator.py."""

    rid: int
    counts: np.ndarray  # (n_pages,) total kv accesses per logical page
    windows: List[TraceWindow]  # raw attach/detach trace windows
    reads: int
    writes: int
    live_hit_ratio: float  # live LRU hit ratio (ground truth, not sampled)
    live_accesses: int
    live_capacity: int  # blocks in the live cache (sizes the validation sim)
    near_hit_rate: float
    # per-tenant views of the same host: access counts over the logical
    # page space and realized near-tier hit rate (interference surface)
    tenant_counts: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    tenant_near_hit: Dict[str, float] = dataclasses.field(default_factory=dict)
    # virtual time one engine step costs on this host (speed x engine cost):
    # lets the aggregator order trace windows by when they actually happened
    # on a heterogeneous fleet, not by per-host step indices. Snapshot at
    # export — window ordering assumes the cost was constant over the
    # traced interval (true for per-host speed factors; a step_cost_fn that
    # varies mid-run would misplace earlier windows)
    step_cost: float = 1.0
    # fleet virtual time this host joined (0 for founding replicas): an
    # elastically added host's engine step counter starts at 0, so its
    # windows happened at clock_offset + start_step * step_cost
    clock_offset: float = 0.0
    # device-executed tiering (runtime/tiered_kv): when the host runs the
    # fused tiered-gather decode path this carries the store's counters
    # (near/far hits counted on device and DRAINED at export — the export
    # boundary is a drain boundary, so fleet epochs never read a stale
    # plane — plus the dispatch/host-sync budget and bytes actually moved
    # by placement pushes); None for hosts on the host-accounted path
    device_tiering: Optional[dict] = None
    # frozen metrics-registry state at export (replica label applied): what
    # a retired host contributes to the fleet metrics merge after its live
    # registry is gone
    metrics: Optional[MetricSnapshot] = None
    # successor table trained from THIS host's stream-tagged trace windows
    # ({block: (succ, ...)}): the per-host export surface of the trace-
    # driven prefetcher. The AutoTierer pools the raw windows of every
    # profile and retrains fleet-wide instead of merging these — but a
    # retired host's table (via extra_profiles) is still inspectable.
    successors: Dict[int, tuple] = dataclasses.field(default_factory=dict)
    # stream id (engine seq id) -> tenant name for every request this host
    # admitted: trace-window streams are seq ids, and this map is what lets
    # the fleet aggregator partition successor training per tenant (one
    # tenant's template chains never enter another tenant's table)
    stream_tenants: Dict[int, str] = dataclasses.field(default_factory=dict)

    @property
    def n_pages(self) -> int:
        """Size of this host's physical page-id space."""
        return int(self.counts.size)


class Replica:
    """A ServingEngine with fleet hooks attached.

    ``live_cache_blocks`` sizes the per-host live cache simulator used as
    ground truth when validating the stitched fleet trace — it plays the
    role of the paper's hardware hit-ratio counters.

    ``speed`` is this host's step-cost multiplier in virtual time (1.0 =
    nominal, 4.0 = a 4x straggler). ``clock``/``busy`` are owned by the
    event-driven fleet run; ``draining`` excludes the host from dispatch
    while it finishes its backlog (elastic scale-down).
    """

    def __init__(
        self,
        rid: int,
        engine: ServingEngine,
        live_cache_blocks: int = 128,
        speed: float = 1.0,
    ):
        self.rid = rid
        self.engine = engine
        self.live_cache_blocks = live_cache_blocks
        self.live_sim = CacheSim(live_cache_blocks)
        self.speed = float(speed)
        self.clock = 0.0  # virtual time of this host's last completion
        self.created_at = 0.0  # fleet vtime this host joined (elastic)
        self.busy = False  # a step is in flight on the event scheduler
        self.draining = False
        # fault state (fleet/faults.py): a dead host is removed from the
        # fleet after crash salvage; a hung host stays listed but is
        # quarantined from dispatch until its fault's recovery event clears
        # the flag (its engine was purged at failover — it rejoins empty)
        self.alive = True
        self.hung = False
        self.steps_done = 0
        engine.access_hooks.append(self._on_access)
        # flight-recorder identity: span tracks and metric series from this
        # host carry its rid (const label, applied at snapshot time so the
        # engine's pre-existing instruments are covered too)
        engine.host_rid = rid
        engine.metrics.const_labels.setdefault("replica", str(rid))

    def _on_access(self, pages: np.ndarray, is_write: bool):
        for p in np.asarray(pages).reshape(-1):
            self.live_sim.access(int(p))

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        self.engine.submit(req)

    def step(self) -> int:
        self.steps_done += 1
        return self.engine.step()

    @property
    def step_cost(self) -> float:
        """Virtual-time cost of this host's next step (straggler = bigger)."""
        return self.speed * self.engine.step_cost()

    @property
    def load(self) -> int:
        return self.engine.load

    @property
    def queue_depth(self) -> int:
        return len(self.engine.queue)

    @property
    def idle(self) -> bool:
        return self.engine.load == 0

    # ------------------------------------------------------------------
    # drain protocol (elastic scale-down): stop receiving, finish backlog

    def start_drain(self):
        self.draining = True

    @property
    def drained(self) -> bool:
        return self.draining and self.idle and not self.busy

    def apply_placement(self, near_ids: np.ndarray, epoch: Optional[int] = None) -> int:
        self.engine.external_placement = True
        return self.engine.apply_placement(near_ids, epoch=epoch)

    # ------------------------------------------------------------------
    # crash protocol (fleet/faults.py): inventory what died, salvage books

    def crash_salvage(self, now: float) -> dict:
        """Inventory a crashed host before retirement.

        The host-visible books — everything the last drain boundary folded
        in, every token already streamed — survive a crash by construction.
        What dies is (a) the device counter plane accumulated since that
        boundary, quarantined here via the discard drain and reported as
        the ``lost_window``, and (b) the in-flight decode progress of
        resident requests, reported as ``lost_decode_tokens`` (the work
        their failover re-dispatch must redo). After this call every
        subsequent drain on the engine sees a clean plane and charges
        nothing — the idempotent-drain guarantee is what makes the
        follow-up ``export_profile``/``stats`` reads crash-safe.
        """
        stranded = self.engine.stranded_requests()
        lost = self.engine.lost_window()
        lost.update(
            rid=self.rid,
            vtime=float(now),
            inflight=len(stranded),
            lost_decode_tokens=int(sum(d for _, d in stranded)),
        )
        return lost

    # ------------------------------------------------------------------
    def export_profile(self) -> ReplicaProfile:
        eng = self.engine
        eng.tracer.stitch()  # flush any open window into tracer.windows
        # drain the device counter plane first: fleet epochs and stitched
        # traces read drained books, never per-step ints (live_counters
        # drains too, but the explicit call keeps tenant_stats — read
        # below — at the same boundary)
        eng.drain_tier_counters()
        live = eng.live_counters()
        sim = self.live_sim
        tenants = {
            name[len("kv."):]: eng.profiler.counts(name).copy()
            for name in eng.profiler.streams("kv.")
        }
        tenant_near = {
            t: ts["near_hits"].value
            / max(ts["near_hits"].value + ts["far_hits"].value, 1)
            for t, ts in eng.tenant_stats.items()
        }
        return ReplicaProfile(
            rid=self.rid,
            counts=eng.profiler.counts("kv").copy(),
            windows=list(eng.tracer.windows),
            reads=live["reads"],
            writes=live["writes"],
            live_hit_ratio=sim.hits / max(sim.hits + sim.misses, 1),
            live_accesses=sim.hits + sim.misses,
            live_capacity=self.live_cache_blocks,
            near_hit_rate=live["near_hit_rate"],
            tenant_counts=tenants,
            tenant_near_hit=tenant_near,
            step_cost=self.step_cost,
            clock_offset=self.created_at,
            device_tiering=None if eng.tiered is None else eng.tiered.stats(),
            metrics=eng.metrics.snapshot(),
            successors=train_successors(eng.tracer.windows[-64:]),
            stream_tenants=dict(eng._seq_tenant),
        )

    def load_successors(self, table: dict):
        """Install a fleet-trained successor table into this host's
        prefetcher (wholesale: the fleet table saw strictly more data)."""
        self.engine.prefetch.load_successors(table)

    @property
    def device_moved_bytes(self) -> int:
        """Bytes the device tier store has actually migrated on this host."""
        return 0 if self.engine.tiered is None else self.engine.tiered.moved_bytes

    def stats(self) -> dict:
        return {
            **self.engine.stats(),
            "rid": self.rid,
            "speed": self.speed,
            "steps_done": self.steps_done,
            "draining": self.draining,
        }
