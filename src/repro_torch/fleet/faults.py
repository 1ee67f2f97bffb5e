"""Deterministic fault injection for the event-driven fleet.

Hyperscale behavior includes the failures: hosts crash mid-burst, hang
without dying, run slow for a while, or lose their near tier and keep
serving from host DRAM. The chaos engine makes those first-class scheduler
events on the fleet's virtual clock — same heap, same ``(time, prio, seq)``
order, FAULT priority so an injected failure at ``t`` strikes before the
completions of ``t`` (the adversarial and deterministic choice). There is
no wall clock and no randomness at injection time; a seeded scenario is a
plain list of ``FaultEvent``s, so the same seed replays the same run
bit-for-bit: identical event order, identical token streams, identical
merged fleet books. ``ChaosEngine.log`` is that anchor in recorded form.

Fault taxonomy (and what each one costs):

* ``crash`` — the host dies instantly. Its host-visible books survive (the
  router salvages them through the last drain boundary); the undrained
  device counter window and all in-flight decode progress are destroyed and
  quantified (``lost_window``, per-tenant ``lost_tokens``); stranded
  requests re-prefill elsewhere. ``duration > 0`` schedules a replacement
  host through the elastic layer.
* ``hang`` — the host stalls: its in-flight step never completes. The
  router's per-dispatch watchdog (``dispatch_timeout``) declares it hung
  and fails it over; a recovery *before* the watchdog fires is a transient
  stall — the host resumes with its slots intact and nothing is lost but
  the stalled step's virtual time.
* ``slowdown`` — the host's step cost is multiplied by ``factor`` for
  ``duration``: a straggler, not a failure. No work is lost; the event
  scheduler charges the slowness to this host alone.
* ``degrade`` — the host's near tier is capacity-zeroed at runtime
  (``ServingEngine.enter_degraded``): it keeps serving far-tier-only until
  the recovery event restores placement. Placement pushes planned before
  the fault are fenced out by epoch.

Correlated multi-host failure is just several events sharing a timestamp —
they land in one scheduler batch, before any completion of that batch.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.fleet.replica import Replica
from repro_torch.fleet.scheduler import FAULT, VirtualScheduler

KINDS = ("crash", "hang", "slowdown", "degrade")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: strike ``rid`` at virtual time ``time``.

    ``duration`` schedules the matching recovery (0 = permanent):
    replacement host for a crash, un-hang for a hang, speed restore for a
    slowdown, ``exit_degraded`` for a degrade. ``factor`` is the slowdown
    multiplier (ignored by other kinds).
    """

    time: float
    kind: str
    rid: int
    duration: float = 0.0
    factor: float = 1.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {KINDS}")


class ChaosEngine:
    """Schedules a fault scenario into every ``FleetRouter.run``.

    Attaching arms the router's failure machinery (watchdog timeout, retry
    budget, backoff) and registers an ``on_run_start`` hook that posts the
    scenario into each run's fresh scheduler exactly once. An empty
    scenario is the control: the armed watchdog posts timeout events that
    every on-time completion cancels, and cancelled events are swept
    without a trace — so a zero-fault chaos run is bit-exact with the
    plain event-driven path.

    ``log`` records ``(vtime, action, rid, applied)`` tuples in execution
    order — the replay-determinism anchor two identical-seed runs must
    match exactly. ``applied=False`` marks a fault that found its target
    already gone (e.g. crashed by an earlier correlated event).
    """

    def __init__(
        self,
        router,
        events: Sequence[FaultEvent],
        dispatch_timeout: Optional[float] = 8.0,
        max_retries: int = 3,
        retry_backoff: float = 1.0,
    ):
        self.router = router
        self.events = sorted(events, key=lambda e: (e.time, e.rid, e.kind))
        self.log: List[Tuple[float, str, int, bool]] = []
        self._installed = False
        router.dispatch_timeout = dispatch_timeout
        router.max_retries = max_retries
        router.retry_backoff = retry_backoff
        router.chaos = self
        router.on_run_start.append(self._install)

    # ------------------------------------------------------------------
    def _install(self, sched: VirtualScheduler):
        """Post the whole scenario into a run's fresh scheduler (once —
        a second ``run`` on the same router replays nothing)."""
        if self._installed:
            return
        self._installed = True
        for ev in self.events:
            sched.post(max(ev.time, sched.now), lambda ev=ev: self._fire(ev), prio=FAULT)

    def _replica(self, rid: int) -> Optional[Replica]:
        for r in self.router.replicas:
            if r.rid == rid:
                return r
        return None

    def _note(self, now: float, action: str, rid: int, applied: bool, **args):
        self.log.append((float(now), action, rid, applied))
        self.router.metrics.counter("faults", kind=action).inc()
        if self.router.recorder is not None:
            self.router.recorder.instant(
                "fault", -1, now, kind=action, replica=rid, applied=applied, **args
            )

    # ------------------------------------------------------------------
    def _fire(self, ev: FaultEvent):
        sched = self.router.scheduler
        now = sched.now
        r = self._replica(ev.rid)
        applied = r is not None and r.alive
        if applied:
            getattr(self, f"_do_{ev.kind}")(r, ev, sched)
        self._note(now, ev.kind, ev.rid, applied, duration=ev.duration)

    def _recovered(self, t0: float, now: float, action: str, rid: int, applied: bool):
        self._note(now, action, rid, applied)
        if applied:
            self.router.metrics.histogram("recovery_vtime").record(now - t0)

    # ---- kind handlers -----------------------------------------------
    def _do_crash(self, r: Replica, ev: FaultEvent, sched: VirtualScheduler):
        t0 = sched.now
        self.router._fail_replica(r, t0, reason="crash", crash=True)
        if ev.duration > 0 and self.router.elastic is not None:

            def replace():
                nr = self.router.elastic.scale_up(
                    sched.now, reason=f"crash-recover rid={ev.rid}"
                )
                self._recovered(t0, sched.now, "crash_recover", nr.rid, True)

            sched.post(t0 + ev.duration, replace, prio=FAULT)

    def _do_hang(self, r: Replica, ev: FaultEvent, sched: VirtualScheduler):
        """Stall the host: the dedup entry stays registered so the in-
        flight step's completion no-ops and the watchdog sees it hung."""
        t0 = sched.now
        r.hung = True
        if ev.duration > 0:

            def recover():
                ok = r.alive and r.hung
                if ok:
                    # before the watchdog fired: drop the stalled step's
                    # dedup entry (its completion must not double-run) and
                    # resume with slots intact. After a failover the entry
                    # is already gone and the engine empty — same clears.
                    ent = self.router._pending.pop(r.rid, None)
                    if ent is not None:
                        sched.cancel(ent[1])
                    r.hung = False
                    r.busy = False
                self._recovered(t0, sched.now, "hang_recover", r.rid, ok)

            sched.post(t0 + ev.duration, recover, prio=FAULT)

    def _do_slowdown(self, r: Replica, ev: FaultEvent, sched: VirtualScheduler):
        t0 = sched.now
        old = r.speed
        r.speed = old * ev.factor
        if ev.duration > 0:

            def restore():
                ok = r.alive
                if ok:
                    r.speed = old
                self._recovered(t0, sched.now, "slowdown_recover", r.rid, ok)

            sched.post(t0 + ev.duration, restore, prio=FAULT)

    def _do_degrade(self, r: Replica, ev: FaultEvent, sched: VirtualScheduler):
        t0 = sched.now
        tierer = self.router.autotierer
        fence = tierer.epoch_seq if tierer is not None else None
        r.engine.enter_degraded(fence_epoch=fence)
        if ev.duration > 0:

            def restore():
                ok = r.alive
                if ok:
                    tierer = self.router.autotierer
                    r.engine.exit_degraded(
                        fence_epoch=tierer.epoch_seq if tierer is not None else None
                    )
                self._recovered(t0, sched.now, "degrade_recover", r.rid, ok)

            sched.post(t0 + ev.duration, restore, prio=FAULT)

    # ------------------------------------------------------------------
    @classmethod
    def seeded(
        cls,
        router,
        seed: int,
        n_faults: int = 3,
        horizon: float = 64.0,
        kinds: Sequence[str] = KINDS,
        mean_duration: float = 8.0,
        **kwargs,
    ) -> "ChaosEngine":
        """Deterministic random scenario: same seed, same fleet — same
        ``FaultEvent`` list, hence the same run, bit for bit."""
        rng = np.random.default_rng(seed)
        rids = [r.rid for r in router.replicas]
        events = []
        for _ in range(n_faults):
            kind = kinds[int(rng.integers(len(kinds)))]
            events.append(
                FaultEvent(
                    time=float(rng.uniform(1.0, max(horizon, 2.0))),
                    kind=kind,
                    rid=rids[int(rng.integers(len(rids)))],
                    duration=float(rng.uniform(0.5, 2.0)) * mean_duration,
                    factor=float(rng.uniform(2.0, 6.0)) if kind == "slowdown" else 1.0,
                )
            )
        return cls(router, events, **kwargs)
