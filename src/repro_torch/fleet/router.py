"""Request routing over N replicas, with prefix-affinity as the headline.

The shared KV page table dedups prompt prefixes *within one host* — sharing
only materializes if requests carrying the same template land on the same
replica while its pages are resident. Prefix-affinity routing is therefore
the fleet-level counterpart of the paper's multi-ASID TLB sharing: it steers
same-code (same-template) requests to the host already holding those
translations, so the per-host dedup the paper measures actually happens at
fleet scale. Round-robin and least-loaded are the controls.

Multi-tenant dispatch: requests are offered into per-tenant queues and a
weighted-fair pick (virtual-time, deterministic tie-break on tenant name)
decides which tenant's head request is routed next — *before* replica
selection. A burst tenant therefore waits behind its own queue while other
tenants keep dispatching at their weighted share; its overload is charged
to its own SLO by the admission controller, never to its neighbors'.

Fleet stepping is event-driven (fleet/scheduler.py): each replica posts a
step-completion event when its ``step_cost`` of virtual time elapses, and
the router dispatches from the tenant queues at every completion batch —
a 4x straggler slows ONE host, not the fleet barrier. The legacy lockstep
path is kept as a compatibility mode (``run(..., lockstep=True)``); with
homogeneous speeds and no scaling events the two schedules are identical
batch for batch, so lockstep-vs-event equivalence is testable bit-exactly.

``simulated_throughput`` scores a fleet run with a simple cost model in
token-equivalents: prefill work not recovered by sharing, plus decode work
inflated by far-tier latency (hw.SERVING_TIERED's relative latencies) — the same
three levers as core/tiering's roofline, in request-serving units.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch.core.hw import SERVING_TIERED
from repro_torch.data.requests import Request, RequestGenerator
from repro_torch.env import env_flag
from repro_torch.fleet.admission import AdmissionController, SLOModel
from repro_torch.fleet.replica import Replica, ReplicaProfile
from repro_torch.fleet.scheduler import ARRIVAL, TIMEOUT, VirtualScheduler
from repro_torch.obs import (
    Histogram,
    MetricSnapshot,
    MetricsRegistry,
    default_recorder,
    merge_snapshots,
)

FAR_LATENCY_REL = SERVING_TIERED[1].latency_rel  # host-DRAM far tier vs HBM

_FALLBACK_SLO = SLOModel()  # cost model for fairness when no admission is set

# default fleet-stepping mode when run() isn't told explicitly; CI flips
# this to exercise the legacy path against the same test suite
_LOCKSTEP_ENV = "REPRO_FLEET_LOCKSTEP"


class RoundRobinPolicy:
    name = "round-robin"

    def __init__(self):
        self._next = 0

    def choose(self, req: Request, replicas: List[Replica]) -> int:
        i = self._next % len(replicas)
        self._next += 1
        return i


class LeastLoadedPolicy:
    name = "least-loaded"

    def choose(self, req: Request, replicas: List[Replica]) -> int:
        return int(np.argmin([r.load for r in replicas]))


class PrefixAffinityPolicy:
    """Route shared-template requests to the replica holding the prefix.

    Unique prompts (prefix_id == -1) fall back to least-loaded. A sticky
    mapping overloaded past ``spill_factor``x the mean load spills to the
    least-loaded replica instead (a hot template must not melt one host).
    Homes are keyed by replica ``rid``, not list position — the elastic
    fleet adds and retires replicas, so positions are not stable. A home
    whose host has been retired is reassigned to the least-loaded replica.
    """

    name = "prefix-affinity"

    def __init__(self, spill_factor: float = 3.0):
        self.spill_factor = spill_factor
        self.home: Dict[int, int] = {}  # prefix_id -> replica rid
        self.affinity_hits = 0
        self.spills = 0

    def choose(self, req: Request, replicas: List[Replica]) -> int:
        loads = [r.load for r in replicas]
        least = int(np.argmin(loads))
        if req.prefix_id < 0:
            return least
        by_rid = {r.rid: idx for idx, r in enumerate(replicas)}
        i = by_rid.get(self.home.get(req.prefix_id, -1))
        if i is None:
            self.home[req.prefix_id] = replicas[least].rid
            return least
        mean = max(sum(loads) / len(loads), 1.0)
        if loads[i] > self.spill_factor * mean and loads[i] > loads[least]:
            self.spills += 1
            return least
        self.affinity_hits += 1
        return i


POLICIES = {
    "round-robin": RoundRobinPolicy,
    "least-loaded": LeastLoadedPolicy,
    "prefix-affinity": PrefixAffinityPolicy,
}


class FleetRouter:
    """Per-tenant queueing + dispatch + stepping of the replica set.

    ``admission`` (optional) gates every offer; ``tenant_weights`` sets the
    weighted-fair dispatch shares (default: equal weights); ``on_step``
    hooks (the AutoTierer, the ElasticFleet) run after every completion
    batch with the current virtual time. In lockstep mode virtual time
    advances by the *max* replica step cost per fleet step — the barrier
    the event-driven scheduler removes.
    """

    def __init__(
        self,
        replicas: List[Replica],
        policy,
        admission: Optional[AdmissionController] = None,
        tenant_weights: Optional[Dict[str, float]] = None,
    ):
        assert replicas
        self.replicas = replicas
        self.policy = policy
        self.admission = admission
        self.tenant_weights = dict(tenant_weights or {})
        # deques: dispatch pops the head of a tenant queue on every
        # completion batch, and list.pop(0) is O(queue) — O(n^2) under a
        # burst-tenant backlog
        self.tenant_queues: Dict[str, Deque[Request]] = {}
        self._vtime: Dict[str, float] = {}  # weighted-fair virtual time
        self.on_step: List = []
        self.fleet_steps = 0
        self.routed = 0
        self.shed = 0
        self.routed_by: Dict[str, int] = {}
        self.shed_by: Dict[str, int] = {}
        # fleet virtual time + queue-wait accounting (virtual-time units)
        self._now = 0.0
        self._enqueue_time: Dict[int, float] = {}  # id(req) -> offer time
        self.wait_samples: Dict[str, List[float]] = {}
        self.scheduler: Optional[VirtualScheduler] = None
        self.mode = "idle"
        self.elastic = None  # ElasticFleet, attached by build_fleet
        self.autotierer = None  # AutoTierer, attached by build_fleet
        self.chaos = None  # ChaosEngine, attached by fleet/faults.py
        # callbacks invoked with each run's fresh scheduler before any
        # event executes — the chaos engine posts its fault events here
        self.on_run_start: List = []
        # ---- failure machinery (fleet/faults.py forces these into use) --
        # per-dispatch watchdog: a started step that hasn't completed
        # within this much virtual time is declared hung and failed over.
        # None (default) disables the watchdog — zero scheduling overhead
        # and bit-identical event books either way (cancelled timeouts
        # leave no trace; see scheduler.py).
        self.dispatch_timeout: Optional[float] = None
        self.max_retries = 3
        self.retry_backoff = 1.0  # re-queue delay: backoff * attempt number
        # in-flight step dedup guard: replica rid -> (step seq, timeout
        # Event). A completion or timeout whose seq no longer matches is
        # stale — its step was failed over — and must be a no-op, which is
        # what stops a slow-but-alive host's late completion from double-
        # counting tokens its retry already re-decoded elsewhere.
        self._pending: Dict[int, tuple] = {}
        self._step_seq = 0
        # terminal outcome ledger: every rid that enters the fleet ends as
        # "completed", "shed", or "failed:<reason>" — outcome_report()
        # flags anything still pending (the no-silent-drops invariant)
        self.admitted_rids: set = set()
        self.outcomes: Dict[int, str] = {}
        self.attempts: Dict[int, int] = {}
        self.owner: Dict[int, int] = {}  # rid -> replica rid serving it
        self._fin_seen: Dict[int, int] = {}  # replica rid -> finished[] index
        # crash-retirement books (salvaged host stats + quantified loss)
        self.crashed_stats: List[dict] = []
        self.crashed_profiles: List[ReplicaProfile] = []
        self.lost_windows: List[dict] = []
        # unified metrics plane: the router's registry carries the fleet-
        # scoped series (routed/shed counters, queue-wait histograms); the
        # fleet metric view is merge_snapshots over this + every replica
        # engine registry + retired profiles (metric_snapshots below)
        self.metrics = MetricsRegistry()
        self.recorder = None  # FlightRecorder, via attach_recorder
        if default_recorder() is not None:
            self.attach_recorder(default_recorder())

    # ------------------------------------------------------------------
    # flight recorder

    def attach_recorder(self, rec):
        """Wire a FlightRecorder into the fleet: it reads this router's
        virtual clock, snapshots on every completion batch, and every
        replica's engine (present and future — see ElasticFleet.scale_up)
        emits spans/metrics through it."""
        self.recorder = rec
        rec.now_fn = lambda: self._now
        rec.register(self.metrics)
        for r in self.replicas:
            self._attach_engine(r)
        if rec.on_step not in self.on_step:
            self.on_step.append(rec.on_step)

    def _attach_engine(self, replica: Replica):
        """Point one replica's engine at the fleet clock + recorder."""
        eng = replica.engine
        eng.now_fn = lambda: self._now
        if self.recorder is not None:
            eng.recorder = self.recorder
            self.recorder.register(eng.metrics)

    # ------------------------------------------------------------------
    # tenant bookkeeping

    def _weight(self, tenant: str) -> float:
        return max(self.tenant_weights.get(tenant, 1.0), 1e-9)

    def _weight_share(self, tenant: str) -> float:
        """This tenant's fair share among tenants the router knows about."""
        known = set(self.tenant_queues) | set(self.tenant_weights) | {tenant}
        total = sum(self._weight(t) for t in known)
        return self._weight(tenant) / max(total, 1e-9)

    def _tenant_backlog_tokens(self, tenant: str) -> float:
        slo = self.admission.slo_for(tenant) if self.admission else _FALLBACK_SLO
        return sum(slo.request_cost(r) for r in self.tenant_queues.get(tenant, ()))

    def queued(self, tenant: Optional[str] = None) -> int:
        if tenant is not None:
            return len(self.tenant_queues.get(tenant, ()))
        return sum(len(q) for q in self.tenant_queues.values())

    @property
    def active_replicas(self) -> List[Replica]:
        """Replicas eligible for new work (draining, dead and quarantined-
        hung hosts excluded)."""
        return [
            r for r in self.replicas if not r.draining and r.alive and not r.hung
        ]

    # ------------------------------------------------------------------
    # offer / dispatch

    def offer(self, req: Request) -> bool:
        """Admission-gate one request into its tenant queue (no routing yet)."""
        tenant = req.tenant
        if self.admission is not None and not self.admission.admit(
            req,
            self.active_replicas,
            tenant_backlog_tokens=self._tenant_backlog_tokens(tenant),
            weight_share=self._weight_share(tenant),
        ):
            self.shed += 1
            self.shed_by[tenant] = self.shed_by.get(tenant, 0) + 1
            self.outcomes[req.rid] = "shed"
            self.metrics.counter("shed", tenant=tenant).inc()
            if self.recorder is not None:
                self.recorder.instant("shed", req.rid, self._now, tenant=tenant)
            return False
        self.tenant_queues.setdefault(tenant, deque()).append(req)
        self._enqueue_time[id(req)] = self._now
        self.admitted_rids.add(req.rid)
        self.metrics.counter("admitted", tenant=tenant).inc()
        if self.recorder is not None:
            self.recorder.instant("admit", req.rid, self._now, tenant=tenant)
            self.recorder.begin("queue", req.rid, self._now, tenant=tenant)
        return True

    def _pick_tenant(self) -> Optional[str]:
        ready = [t for t, q in self.tenant_queues.items() if q]
        if not ready:
            return None
        return min(ready, key=lambda t: (self._vtime.get(t, 0.0), t))

    def dispatch(self, budget: Optional[int] = None) -> int:
        """Route up to ``budget`` queued requests (all, if None) in
        weighted-fair tenant order; returns number routed."""
        n = 0
        while budget is None or n < budget:
            targets = self.active_replicas
            if not targets:
                break
            tenant = self._pick_tenant()
            if tenant is None:
                break
            req = self.tenant_queues[tenant].popleft()
            chosen = targets[self.policy.choose(req, targets)]
            chosen.submit(req)
            self.owner[req.rid] = chosen.rid
            wait = self._now - self._enqueue_time.pop(id(req), self._now)
            self.wait_samples.setdefault(tenant, []).append(wait)
            self.metrics.histogram("queue_wait", tenant=tenant).record(wait)
            self.routed += 1
            self.routed_by[tenant] = self.routed_by.get(tenant, 0) + 1
            self.metrics.counter("routed", tenant=tenant).inc()
            if self.recorder is not None:
                self.recorder.end("queue", req.rid, self._now, wait=wait)
                self.recorder.instant(
                    "dispatch", req.rid, self._now, tenant=tenant, replica=chosen.rid
                )
            # virtual time advances by inverse weight: a weight-2 tenant is
            # picked twice as often as a weight-1 tenant under contention
            self._vtime[tenant] = self._vtime.get(tenant, 0.0) + 1.0 / self._weight(tenant)
            n += 1
        return n

    def submit(self, req: Request) -> bool:
        """Offer + immediately drain the queues; returns False if shed.

        The one-call path used when arrivals are not rate-limited — with a
        single tenant this is exactly direct routing.
        """
        admitted = self.offer(req)
        self.dispatch()
        return admitted

    # ------------------------------------------------------------------
    # lockstep stepping (compatibility mode)

    def step(self) -> int:
        """One barrier step: every replica advances once, the fleet clock
        advances by the SLOWEST replica's cost — the straggler tax."""
        decoded = 0
        for r in self.replicas:
            decoded += r.step()
            self._note_finished(r)
        self.fleet_steps += 1
        self._now += max(r.step_cost for r in self.replicas)
        for r in self.replicas:
            r.clock = self._now
        for hook in self.on_step:
            hook(self._now)
        return decoded

    @property
    def free_slots(self) -> int:
        return sum(
            sum(1 for s in r.engine.slots if not s.active)
            for r in self.active_replicas
        )

    @property
    def drained(self) -> bool:
        """No queued work anywhere — valid under out-of-order completion:
        an in-flight event step holds engine state (busy slots or queue), so
        it keeps this False until its completion retires the work."""
        return self.queued() == 0 and all(r.idle and not r.busy for r in self.replicas)

    def run(
        self,
        gen,
        n_requests: int,
        max_steps: int = 10_000,
        submit_per_step: Optional[int] = None,
        lockstep: Optional[bool] = None,
    ) -> dict:
        """Serve ``n_requests``: all up-front, or ``submit_per_step`` per
        unit of virtual time (open-loop arrivals, what admission acts on).

        ``gen`` is a RequestGenerator or any iterator of Requests (e.g. a
        multi-tenant ``data.requests.interleave`` merge). Offered requests
        wait in per-tenant queues; dispatch into free decode slots happens
        in weighted-fair tenant order at every completion batch (event
        mode) or once per barrier step (``lockstep=True``). ``max_steps``
        bounds virtual time (event) / fleet iterations (lockstep) — the
        same number when speeds are homogeneous.
        """
        if lockstep is None:
            lockstep = env_flag(_LOCKSTEP_ENV, default=False)
        it = iter(gen)
        pending = deque(next(it) for _ in range(n_requests))
        if lockstep:
            self._run_lockstep(pending, max_steps, submit_per_step)
        else:
            self._run_events(pending, max_steps, submit_per_step)
        return self.fleet_stats()

    def _run_lockstep(self, pending, max_steps, submit_per_step):
        if self.chaos is not None and getattr(self.chaos, "events", ()):
            raise ValueError(
                "fault injection requires the event-driven mode: faults are "
                "scheduler events, and lockstep has no scheduler"
            )
        self.mode = "lockstep"
        if submit_per_step is None:
            for req in pending:
                self.submit(req)
            pending = []
        steps = 0
        while (pending or not self.drained) and steps < max_steps:
            for _ in range(min(submit_per_step or 0, len(pending))):
                self.offer(pending.popleft())
            self.dispatch(max(self.free_slots, 0))
            self.step()
            steps += 1

    def _run_events(self, pending, max_steps, submit_per_step):
        """Event-driven serve: completions free capacity, capacity pulls
        from the tenant queues, idle hosts consume no virtual time."""
        self.mode = "event"
        sched = VirtualScheduler()
        sched.now = self._now
        self.scheduler = sched
        horizon = self._now + float(max_steps)
        # chaos engines (and any other fault source) post their events into
        # the fresh scheduler here, before anything executes
        for hook in list(self.on_run_start):
            hook(sched)

        def quiescent(now: float):
            self._now = now
            for hook in list(self.on_step):
                hook(now)
            self.dispatch(max(self.free_slots, 0))
            self._start_steps(sched)

        if submit_per_step is None:
            for req in pending:
                self.submit(req)
            pending.clear()
            quiescent(sched.now)  # start the first steps (no events yet)
        else:

            def arrive():
                self._now = sched.now  # offers stamp enqueue at batch time
                for _ in range(min(submit_per_step, len(pending))):
                    self.offer(pending.popleft())
                # lockstep offers at iteration starts 0..max_steps-1, so
                # arrivals stop strictly before the horizon — an extra
                # batch at t == horizon would break truncated-run equality
                if pending and sched.now + 1.0 < horizon:
                    sched.post(sched.now + 1.0, arrive, prio=ARRIVAL)

            sched.post(sched.now, arrive, prio=ARRIVAL)

        sched.run(until=horizon, quiescent=quiescent)
        # scheduler activity enters the registry once per run (pure sums,
        # so cadence-independent like every other mirrored series)
        self.metrics.counter("sched_events").inc(sched.events_run)
        self.metrics.counter("sched_batches").inc(sched.batches)
        # a horizon-truncated run leaves completion events unexecuted in
        # the discarded scheduler; those steps never happened (no engine
        # mutation), so clear the in-flight markers or the replicas would
        # be stuck busy forever and a follow-up run() could never step them
        for r in self.replicas:
            r.busy = False
        self._pending.clear()  # in-flight dedup entries die with the heap
        self._now = sched.now
        # event mode has no barrier iterations; report virtual-time ticks
        # elapsed — the lockstep-equivalent step count at nominal speeds
        # (per-replica true step counts are in per_replica["steps_done"])
        self.fleet_steps = int(round(self._now))

    def _start_steps(self, sched: VirtualScheduler):
        """Begin a step on every replica that has work and no step in
        flight (draining hosts keep stepping to empty their backlog; dead
        and hung hosts never restart one).

        Each started step registers a dedup entry (rid -> (seq, timeout
        event)). The completion consumes the entry and cancels its timeout
        — a cancelled timeout is swept without advancing the clock or
        forming a batch, so with no faults the event books are bit-exact
        with the watchdog-free path. A completion that finds its entry
        gone (or superseded) is stale: the step was failed over, and
        running it would double-count tokens the retry re-decoded — it
        no-ops instead."""
        for r in list(self.replicas):
            if r.busy or r.load <= 0 or not r.alive or r.hung:
                continue
            r.busy = True
            t_begin = sched.now
            self._step_seq += 1
            seq = self._step_seq

            def complete(r=r, t_begin=t_begin, seq=seq):
                ent = self._pending.get(r.rid)
                if ent is None or ent[0] != seq or not r.alive or r.hung:
                    return  # stale: this step was failed over (dedup guard)
                self._pending.pop(r.rid)
                sched.cancel(ent[1])
                self._now = sched.now
                r.busy = False
                r.clock = sched.now
                decoded = r.step()
                self._note_finished(r)
                rec = self.recorder
                if rec is not None and rec.step_spans:
                    rec.span(
                        "step", -1, t_begin, sched.now, replica=r.rid, decoded=decoded
                    )

            sched.post(sched.now + r.step_cost, complete)
            timeout_ev = None
            if self.dispatch_timeout is not None:

                def expire(r=r, seq=seq):
                    self._on_step_timeout(r, seq)

                timeout_ev = sched.post(
                    t_begin + self.dispatch_timeout, expire, prio=TIMEOUT
                )
            self._pending[r.rid] = (seq, timeout_ev)

    # ------------------------------------------------------------------
    # failure machinery: watchdog, failover, crash retirement, retry

    def _note_finished(self, r: Replica):
        """Fold a replica's newly finished seq ids (engine seq id == request
        rid) into the terminal-outcome ledger. Runs after every engine step
        in both stepping modes, so completions are recorded at the batch
        they happen — a later failover of the same host cannot retro-lose
        them."""
        fin = r.engine.finished
        seen = self._fin_seen.get(r.rid, 0)
        if len(fin) > seen:
            for rid in fin[seen:]:
                self.outcomes[rid] = "completed"
                self.owner.pop(rid, None)
            self._fin_seen[r.rid] = len(fin)

    def _on_step_timeout(self, r: Replica, seq: int):
        """Watchdog expiry for one dispatched step. A consumed or
        superseded dedup entry means the step completed (its completion
        cancelled this event — we only get here through a race the
        scheduler's ordering actually forbids) or was already failed over;
        a live entry past the deadline is a hung host."""
        ent = self._pending.get(r.rid)
        if ent is None or ent[0] != seq or not r.alive:
            return
        self._fail_replica(r, self.scheduler.now, reason="timeout", crash=False)

    def _fail_replica(self, r: Replica, now: float, reason: str, crash: bool):
        """Fail one host over: quarantine (hang) or retire (crash) it,
        abort its engine, and re-dispatch every stranded request.

        The dedup entry is removed FIRST, so a slow-but-alive host's late
        completion event finds nothing to match and no-ops — the retry's
        re-decoded tokens are the only ones that count. Aborted requests'
        discarded decode progress is charged to per-tenant ``lost_tokens``
        (the work the retry redoes); a crash additionally quarantines the
        host's undrained device counter plane as a ``lost_window`` (see
        Replica.crash_salvage)."""
        ent = self._pending.pop(r.rid, None)
        if ent is not None and self.scheduler is not None:
            self.scheduler.cancel(ent[1])
        self._now = now
        # completions already in the engine's books stay counted
        self._note_finished(r)
        if crash:
            r.alive = False
            r.busy = False
            stranded = self._retire_crashed(r, now, reason)
        else:
            r.hung = True  # quarantined until a recovery event clears it
            stranded = r.engine.abort_all()
        self.metrics.counter("replica_failures", reason=reason).inc()
        if self.recorder is not None:
            self.recorder.instant(
                "failover",
                -1,
                now,
                replica=r.rid,
                reason=reason,
                crash=crash,
                inflight=len(stranded),
            )
        for req, discarded in stranded:
            if discarded:
                self.metrics.counter("lost_tokens", tenant=req.tenant).inc(discarded)
            self._retry(req, now, reason)

    def _retire_crashed(self, r: Replica, now: float, reason: str) -> list:
        """Crash-path retirement: salvage the dead host's last-drain books,
        quantify what the crash destroyed, remove it from the fleet.

        Ordering matters: the salvage (read-only inventory + discard drain)
        runs before the profile export, so the export's own drain sees a
        clean plane and charges nothing — the host-visible history that
        survives is exactly what the last real drain boundary folded in.
        Returns the aborted (request, discarded_tokens) pairs for retry."""
        lost = r.crash_salvage(now)
        lost["reason"] = reason
        self.lost_windows.append(lost)
        prof = r.export_profile()
        self.crashed_profiles.append(prof)
        if self.autotierer is not None:
            # a dead host's traffic still shaped the service's histogram
            self.autotierer.extra_profiles.append(prof)
        st = r.stats()
        st["placement_near_hits"] = r.engine.placement.stats.near_hits
        st["placement_far_hits"] = r.engine.placement.stats.far_hits
        st["crashed"] = True
        st["crash_reason"] = reason
        self.crashed_stats.append(st)
        stranded = r.engine.abort_all()
        if r in self.replicas:
            self.replicas.remove(r)
        if self.elastic is not None:
            self.elastic.retire_crashed(r, now, reason)
        return stranded

    def _retry(self, req: Request, now: float, reason: str):
        """Re-dispatch one stranded request: re-queue (re-prefill from the
        retained prompt — its KV pages died with the slot) after a linear
        backoff, or declare it failed once retries are exhausted."""
        tenant = req.tenant
        self.metrics.counter("failovers", tenant=tenant).inc()
        n = self.attempts.get(req.rid, 0) + 1
        self.attempts[req.rid] = n
        self.owner.pop(req.rid, None)
        if n > self.max_retries:
            self.outcomes[req.rid] = f"failed:{reason}"
            self.metrics.counter("failed", tenant=tenant).inc()
            if self.recorder is not None:
                self.recorder.instant(
                    "failed", req.rid, now, tenant=tenant, reason=reason, attempts=n - 1
                )
            return
        self.metrics.counter("retries", tenant=tenant).inc()
        if self.recorder is not None:
            self.recorder.instant(
                "retry", req.rid, now, tenant=tenant, reason=reason, attempt=n
            )
        delay = self.retry_backoff * n
        sched = self.scheduler
        if sched is not None and delay > 0:
            sched.post(now + delay, lambda req=req: self._requeue(req), prio=ARRIVAL)
        else:
            self._requeue(req)

    def _requeue(self, req: Request):
        """Put a failed-over request back at the tail of its tenant queue
        (dispatch pulls it at the next completion batch)."""
        if self.scheduler is not None:
            self._now = self.scheduler.now
        self.tenant_queues.setdefault(req.tenant, deque()).append(req)
        self._enqueue_time[id(req)] = self._now
        if self.recorder is not None:
            self.recorder.begin("queue", req.rid, self._now, tenant=req.tenant, retry=True)

    def outcome_report(self) -> dict:
        """Terminal-outcome ledger: every request that entered the fleet
        must end ``completed``, ``shed``, or ``failed:<reason>``. Anything
        admitted but unresolved is listed in ``pending`` — the no-silent-
        drops invariant chaos tests assert empty (a truncated horizon or an
        unrecovered last host legitimately leaves work pending; a completed
        run must not)."""
        counts: Dict[str, int] = {}
        for o in self.outcomes.values():
            key = "failed" if o.startswith("failed") else o
            counts[key] = counts.get(key, 0) + 1
        pending = sorted(r for r in self.admitted_rids if r not in self.outcomes)
        return {
            "offered": len(self.outcomes) + len(pending),
            "admitted": len(self.admitted_rids),
            "outcomes": counts,
            "pending": pending,
            "failed": {
                r: o for r, o in sorted(self.outcomes.items()) if o.startswith("failed")
            },
            "complete": not pending,
        }

    def _tenant_count(self, name: str, tenant: str) -> int:
        """Non-creating per-tenant counter read (no empty series growth)."""
        c = self.metrics._counters.get((name, (("tenant", tenant),)))
        return 0 if c is None else c.value

    # ------------------------------------------------------------------
    def export_profiles(self) -> List[ReplicaProfile]:
        """Live replicas' profiles + retired hosts folded in by the
        elastic layer — the full fleet history the aggregator stitches."""
        profs = [r.export_profile() for r in self.replicas]
        if self.elastic is not None:
            profs += list(self.elastic.retired_profiles)
        profs += list(self.crashed_profiles)
        return profs

    def fleet_stats(self) -> dict:
        per = [r.stats() for r in self.replicas]
        retired = list(self.elastic.retired_stats) if self.elastic is not None else []
        # retired AND crashed hosts' service history stays in the fleet
        # totals — neither a scale-down nor a failure makes served traffic
        # disappear from the books (what a crash destroys is quantified
        # separately in lost_windows, never silently)
        gone = retired + list(self.crashed_stats)
        both = per + gone
        agg = {
            k: sum(s[k] for s in both)
            for k in (
                "tokens_decoded",
                "requests_finished",
                "prefill_tokens",
                "prefill_tokens_saved",
            )
        }
        hits = sum(r.engine.placement.stats.near_hits for r in self.replicas)
        hits += sum(s["placement_near_hits"] for s in gone)
        tot = hits + sum(r.engine.placement.stats.far_hits for r in self.replicas)
        tot += sum(s["placement_far_hits"] for s in gone)
        agg["near_hit_rate"] = hits / max(tot, 1)
        agg["shared_mappings"] = sum(s["pagetable"]["shared_mappings"] for s in both)
        agg["fleet_steps"] = self.fleet_steps
        agg["virtual_time"] = self._now
        agg["mode"] = self.mode
        agg["n_replicas"] = len(self.replicas)
        agg["routed"] = self.routed
        agg["shed"] = self.shed
        agg["policy"] = getattr(self.policy, "name", type(self.policy).__name__)
        # fault/failover books (all zero/empty on a fault-free run, and
        # present in BOTH stepping modes so chaos reports diff cleanly)
        agg["requests_failed"] = sum(
            1 for o in self.outcomes.values() if o.startswith("failed")
        )
        agg["requests_retried"] = int(self.metrics.total("retries"))
        agg["failovers"] = int(self.metrics.total("replica_failures"))
        agg["lost_tokens"] = int(self.metrics.total("lost_tokens"))
        agg["crashed_replicas"] = [s["rid"] for s in self.crashed_stats]
        agg["lost_windows"] = [dict(w) for w in self.lost_windows]
        agg["fault_events"] = list(self.chaos.log) if self.chaos is not None else []
        agg["simulated_throughput"] = simulated_throughput(agg)
        agg["tenants"] = self.tenant_report(both)
        agg["per_replica"] = per
        if self.elastic is not None:
            agg["retired_replicas"] = retired
            agg["scale_events"] = [
                (e.vtime, e.action, e.rid) for e in self.elastic.events
            ]
        return agg

    def tenant_report(self, per_replica_stats: Optional[List[dict]] = None) -> dict:
        """Fleet-wide per-tenant view: service counts, tier hits, routing,
        and queue-wait latency percentiles in virtual time (p50/p99 of the
        offer->dispatch wait — the fairness surface a burst tenant stresses)."""
        per = per_replica_stats or [r.stats() for r in self.replicas]
        out: Dict[str, dict] = {}
        for s in per:
            for t, ts in s.get("tenants", {}).items():
                o = out.setdefault(
                    t,
                    {"tokens_decoded": 0, "requests_finished": 0, "near_hits": 0, "far_hits": 0},
                )
                for k in ("tokens_decoded", "requests_finished", "near_hits", "far_hits"):
                    o[k] += ts[k]
        for t in set(out) | set(self.routed_by) | set(self.shed_by):
            o = out.setdefault(
                t,
                {"tokens_decoded": 0, "requests_finished": 0, "near_hits": 0, "far_hits": 0},
            )
            o["near_hit_rate"] = o["near_hits"] / max(o["near_hits"] + o["far_hits"], 1)
            o["routed"] = self.routed_by.get(t, 0)
            o["shed"] = self.shed_by.get(t, 0)
            o["shed_rate"] = o["shed"] / max(o["routed"] + o["shed"], 1)
            o["queued"] = self.queued(t)
            # fault columns only appear once a tenant was actually touched
            # by a failure — a fault-free run's report is byte-identical to
            # the pre-chaos one (the lockstep/event equivalence surface)
            for k in ("retries", "failovers", "failed", "lost_tokens"):
                v = self._tenant_count(k, t)
                if v:
                    o[k] = v
            # queue-wait percentiles come from the mergeable exponential
            # histogram (deterministic bucket upper bounds, ~9% relative
            # error at the default growth) — NOT np.percentile over the raw
            # sample list, which cannot merge across routers/windows.
            # wait_samples keeps the raw list for exact-replay comparisons.
            # A tenant with NO samples gets no percentile keys at all:
            # Histogram.quantile returns None on an empty series, and
            # zero-filling here used to make "never waited" and "no data"
            # indistinguishable in the report.
            h = self.metrics.histogram("queue_wait", tenant=t)
            if h.count:
                o["wait_p50"] = h.quantile(0.50)
                o["wait_p99"] = h.quantile(0.99)
            # time-to-first-token (submit -> first generated token, virtual
            # time): recorded by each ENGINE — at admit under whole-slot
            # prefill, at the prompt-completing chunk step under chunked
            # prefill — into its registry's per-tenant "ttft" histogram;
            # merged bucket-wise across replicas, same grid as queue_wait.
            # Read without the creating .histogram() accessor so replicas
            # that never served this tenant don't grow empty series.
            th = Histogram()
            for r in self.replicas:
                eh = r.engine.metrics._histograms.get(
                    ("ttft", (("tenant", t),))
                )
                if eh is not None:
                    th.merge(eh)
            if th.count:
                o["ttft_p50"] = th.quantile(0.50)
                o["ttft_p99"] = th.quantile(0.99)
        return out

    # ------------------------------------------------------------------
    # unified metrics plane (fleet view)

    def metric_snapshots(self) -> List[MetricSnapshot]:
        """Every registry's frozen state: router + live replicas + retired
        hosts (whose snapshots ride in their exported profiles)."""
        for r in self.replicas:
            r.engine.drain_tier_counters()  # snapshot at a drain boundary
        snaps = [self.metrics.snapshot()]
        if self.admission is not None:
            snaps.append(self.admission.metrics.snapshot())
        snaps += [r.engine.metrics.snapshot() for r in self.replicas]
        if self.elastic is not None:
            snaps += [
                p.metrics for p in self.elastic.retired_profiles if p.metrics is not None
            ]
        snaps += [p.metrics for p in self.crashed_profiles if p.metrics is not None]
        return snaps

    def fleet_metrics(self) -> MetricSnapshot:
        """Exact fleet merge of every per-host registry — same totals as
        ``fleet_stats`` bit-for-bit (counters are plain int sums), plus the
        label dimensions and histograms the legacy dicts never had."""
        return merge_snapshots(self.metric_snapshots())


def simulated_throughput(stats: dict) -> float:
    """Useful tokens per modeled unit cost (higher is better).

    cost = unshared prefill work + decode work weighted by the average
    KV-read latency its near/far split implies. Prefix sharing removes
    prefill cost; good placement removes the far-latency multiplier.
    """
    useful = stats["prefill_tokens"] + stats["tokens_decoded"]
    near = stats["near_hit_rate"]
    avg_latency = near + (1.0 - near) * FAR_LATENCY_REL
    cost = (
        stats["prefill_tokens"]
        - stats["prefill_tokens_saved"]
        + stats["tokens_decoded"] * avg_latency
    )
    return useful / max(cost, 1e-9)
