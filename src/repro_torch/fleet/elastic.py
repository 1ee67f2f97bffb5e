"""Elastic replica set: scale on door pressure, warm from the fleet plan.

Hyperscale services don't run a fixed host count — they trade hosts against
time-varying load. This layer closes that loop over the event-driven fleet:

* **scale-up** fires when the admission controller's door pressure rises
  (recent shed rate, or projected queueing delay near the SLO budget). The
  new replica does NOT cold-start its tiering: its near tier is warmed from
  the AutoTierer's latest fleet plan, because the plan is a property of the
  *service* (the aggregated fleet histogram), not of the host — the paper's
  "same code on many hosts" premise is exactly what makes the handoff valid.
* **scale-down** drains before removal: the victim stops receiving new work
  (``Replica.start_drain``) but keeps stepping its backlog; once idle its
  MemProf profile is exported and folded into the fleet aggregate
  (``retired_profiles`` + the AutoTierer's ``extra_profiles``), so the
  stitched fleet trace and the tiering histogram keep the full service
  history across topology changes.

Attach as a ``FleetRouter.on_step`` hook: it re-evaluates after every
completion batch with the fleet's virtual clock, entirely deterministic.

Params for new hosts default to the fleet's shared (cached) weights; a
production fleet hands ``params_source`` a closure over
``runtime/elastic.elastic_restore`` (see ``restored_params_source``) so a
joining host restores the serving checkpoint onto its own device topology —
the same resize/recovery path the trainer uses.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

from repro_torch.fleet.admission import AdmissionController, SLOModel
from repro_torch.fleet.replica import Replica, ReplicaProfile


@dataclasses.dataclass
class ScaleEvent:
    vtime: float
    action: str  # "up" | "drain" | "retire"
    rid: int
    n_active: int  # non-draining replicas after the action
    reason: str = ""


def restored_params_source(manager, template, mesh=None, specs=None, step=None):
    """Params source for scaled-up replicas via the trainer's elastic-restore
    path: a joining host restores the latest serving checkpoint onto its own
    (possibly different) mesh — reshard-on-restore, not weight transfer."""
    from repro_torch.runtime.elastic import elastic_restore

    def source():
        state, _extras = elastic_restore(manager, template, mesh, specs=specs, step=step)
        return state

    return source


class ElasticFleet:
    """Scales ``router.replicas`` (the list shared with the AutoTierer,
    mutated in place) between ``min_replicas`` and ``max_replicas``.

    Decisions use two signals sampled at most once per ``cooldown`` of
    virtual time: the shed rate over the interval since the last decision
    (time-local, so it decays when the burst ends — a cumulative rate never
    would) and the admission controller's projected backlog as a fraction
    of the SLO budget. Without an admission controller, backlog pressure is
    computed directly from engine queues against slot capacity.
    """

    def __init__(
        self,
        router,
        replica_factory: Callable[[int], Replica],
        autotierer=None,
        min_replicas: int = 1,
        max_replicas: int = 8,
        up_shed_rate: float = 0.05,
        up_backlog_frac: float = 0.75,
        down_backlog_frac: float = 0.10,
        cooldown: float = 8.0,
    ):
        assert min_replicas >= 1 and max_replicas >= min_replicas
        self.router = router
        self.factory = replica_factory
        self.autotierer = autotierer
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.up_shed_rate = up_shed_rate
        self.up_backlog_frac = up_backlog_frac
        self.down_backlog_frac = down_backlog_frac
        self.cooldown = cooldown
        self.retired_profiles: List[ReplicaProfile] = []
        self.retired_stats: List[dict] = []  # folded into fleet_stats
        self.events: List[ScaleEvent] = []
        self._next_rid = max((r.rid for r in router.replicas), default=-1) + 1
        self._last_decision = float("-inf")
        self._prev_offered = 0
        self._prev_shed = 0

    def _record_event(self, ev: ScaleEvent):
        """Every scale event is a fleet-track instant + a labeled counter."""
        self.events.append(ev)
        self.router.metrics.counter("scale_events", action=ev.action).inc()
        rec = self.router.recorder
        if rec is not None:
            rec.instant(
                f"scale_{ev.action}",
                -1,
                ev.vtime,
                n_active=ev.n_active,
                rid=ev.rid,
                reason=ev.reason,
            )

    # ------------------------------------------------------------------
    # pressure signals

    def _interval_shed_rate(self) -> float:
        """Shed fraction of offers since the previous scaling decision."""
        adm = self.router.admission
        if adm is None:
            return 0.0
        d_off = adm.offered - self._prev_offered
        d_shed = adm.shed - self._prev_shed
        self._prev_offered, self._prev_shed = adm.offered, adm.shed
        return d_shed / d_off if d_off > 0 else 0.0

    def pressure(self) -> dict:
        active = self.router.active_replicas
        # no admission controller at the door: read the same pressure math
        # through a default-SLO controller so both paths share one cost
        # model (its empty decision window reports shed_rate 0.0)
        adm = self.router.admission or AdmissionController(SLOModel())
        p = adm.pressure(active)
        p["queued"] = self.router.queued()
        p["n_active"] = len(active)
        return p

    # ------------------------------------------------------------------
    def __call__(self, now: float):
        """Router hook: retire finished drains, then maybe scale."""
        self._retire_drained(now)
        if now - self._last_decision < self.cooldown:
            return
        p = self.pressure()
        shed = self._interval_shed_rate()
        self._last_decision = now
        if (shed > self.up_shed_rate or p["backlog_frac"] > self.up_backlog_frac) and p[
            "n_active"
        ] < self.max_replicas:
            reason = f"shed={shed:.2f} backlog={p['backlog_frac']:.2f}"
            self.scale_up(now, reason=reason)
        elif (
            shed == 0.0
            and p["queued"] == 0
            and p["backlog_frac"] < self.down_backlog_frac
            and p["n_active"] > self.min_replicas
        ):
            self.scale_down(now, reason=f"backlog={p['backlog_frac']:.2f}")

    # ------------------------------------------------------------------
    def scale_up(self, now: float, reason: str = "manual") -> Replica:
        """Add one replica, near tier pre-warmed from the fleet plan."""
        r = self.factory(self._next_rid)
        self._next_rid += 1
        r.clock = now
        r.created_at = now  # stitched windows key off the join time
        # a joining host reports through the fleet's clock and recorder
        # from its first step (before the warm placement push, which emits
        # a migrate span of its own)
        self.router._attach_engine(r)
        warm = self.autotierer.warm_near_ids() if self.autotierer is not None else None
        if warm is not None:
            # the fleet plan is the service's hotness, valid on any host
            r.apply_placement(warm)
        if self.autotierer is not None:
            table = self.autotierer.warm_successors()
            if table:
                # the prefetch plane warms with the tier plane: learned
                # sequences are a service property too
                r.load_successors(table)
        self.router.replicas.append(r)
        self._last_decision = now
        self._record_event(
            ScaleEvent(now, "up", r.rid, len(self.router.active_replicas), reason)
        )
        return r

    def scale_down(self, now: float, reason: str = "manual") -> Optional[Replica]:
        """Start draining one replica (youngest host first, deterministic)."""
        active = self.router.active_replicas
        if len(active) <= self.min_replicas:
            return None
        victim = max(active, key=lambda r: r.rid)
        victim.start_drain()
        self._last_decision = now
        self._record_event(
            ScaleEvent(now, "drain", victim.rid, len(self.router.active_replicas), reason)
        )
        return victim

    def retire_crashed(self, replica: Replica, now: float, reason: str = "crash"):
        """Record a crash retirement in the scaling history.

        The router's fault machinery already salvaged the host's books
        (``router.crashed_stats`` / ``crashed_profiles`` / ``lost_windows``
        — crash books are quarantined there, NOT folded into
        ``retired_stats``, so drained and crashed history stay separately
        attributable) and removed it from the shared replica list. This
        hook records the topology event and resets the decision clock so
        the autoscaler doesn't immediately react to its own casualty. A
        host that was already draining when it crashed is retired exactly
        once, here: it is gone from the shared list, so a pending
        ``_retire_drained`` can never see it again."""
        self._last_decision = now
        self._record_event(
            ScaleEvent(
                now, "crash", replica.rid, len(self.router.active_replicas), reason
            )
        )

    def _retire_drained(self, now: float):
        """Remove fully drained hosts, folding their profile into the
        fleet aggregate so their history survives them."""
        for r in [r for r in self.router.replicas if r.drained]:
            prof = r.export_profile()
            self.retired_profiles.append(prof)
            if self.autotierer is not None:
                self.autotierer.extra_profiles.append(prof)
            st = r.stats()
            # tier-hit counters live on the placement object, not in
            # engine.stats(); snapshot them so fleet near-hit stays exact
            st["placement_near_hits"] = r.engine.placement.stats.near_hits
            st["placement_far_hits"] = r.engine.placement.stats.far_hits
            self.retired_stats.append(st)
            self.router.replicas.remove(r)
            self._record_event(
                ScaleEvent(now, "retire", r.rid, len(self.router.active_replicas))
            )
