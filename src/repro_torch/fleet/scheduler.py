"""Virtual-time event scheduler: the fleet's clock without the barrier.

Lockstep stepping (``FleetRouter.step`` calling every replica once per
global tick) encodes a hidden assumption the paper's fleet data refutes:
that all hosts are equally fast. Per-host heterogeneity is first-order at
hyperscale — one 4x-slow host must cost the fleet one slow *replica*, not a
4x-slow *barrier*. This module provides the discrete-event core that makes
stragglers a scenario instead of a bug: each replica runs on its own clock,
posts a completion event when its step's virtual-time cost elapses, and the
router dispatches queued work the moment capacity frees.

Determinism is the design constraint: events execute in
``(time, priority, seq)`` order, where ``seq`` is posting order — there is
no wall clock, no thread, no hash-order anywhere, so a seeded run replays
exactly. With homogeneous step costs the event schedule degenerates to the
lockstep schedule (completions for all busy replicas land on the same
timestamp, in replica order), which is what lets the router guarantee
bit-exact equivalence with the legacy lockstep mode.

Cancellation: ``post`` returns the Event handle and ``cancel`` marks it
dead in place (lazy heap removal). A cancelled event is popped and skipped
without executing, without advancing ``now``, without counting toward
``events_run``, and without forming a quiescent batch — so a timeout event
that its completion races and cancels leaves NO trace in the event order,
which is what makes a zero-fault chaos config bit-exact with the plain
event-driven path.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, List, Optional

# Priorities order same-timestamp events the way one lockstep iteration
# orders its phases: fault injections strike first (a crash at t beats a
# completion at t — the adversarial and deterministic choice), then step
# completions retire work and free slots, then open-loop arrivals are
# offered to admission, then watchdog timeouts (a completion landing
# exactly on its deadline counts as on time). Dispatch is not an event —
# it runs in the quiescent hook after every batch.
FAULT = -1
COMPLETION = 0
ARRIVAL = 1
TIMEOUT = 2


@dataclasses.dataclass(order=True)
class Event:
    time: float
    prio: int
    seq: int
    action: Callable[[], None] = dataclasses.field(compare=False)
    cancelled: bool = dataclasses.field(default=False, compare=False)


class VirtualScheduler:
    """Ordered event heap over virtual time.

    ``run`` drains events in (time, prio, seq) order. All live events
    sharing a timestamp form one *batch*; after each batch the
    ``quiescent`` callback runs once — that is where the fleet router
    fires its hooks, dispatches from the weighted-fair tenant queues into
    freed slots, and starts new replica steps (posting their completion
    events). Actions may post further events, including at the current
    timestamp, and may cancel any not-yet-executed event.
    """

    def __init__(self):
        self._heap: List[Event] = []
        self._seq = itertools.count()
        self.now = 0.0
        self.events_run = 0
        self.events_cancelled = 0  # cancelled events swept past (never run)
        self.batches = 0  # quiescent batches (same-timestamp event groups)

    def post(
        self, time: float, action: Callable[[], None], prio: int = COMPLETION
    ) -> Event:
        if time < self.now:
            raise ValueError(f"event scheduled in the past: {time} < {self.now}")
        ev = Event(float(time), prio, next(self._seq), action)
        heapq.heappush(self._heap, ev)
        return ev

    def cancel(self, ev: Optional[Event]) -> bool:
        """Mark an event dead; it is swept (not executed) when reached.

        Returns True if this call transitioned the event to cancelled.
        Safe on None and on already-cancelled events (idempotent), so
        callers can cancel unconditionally on every teardown path.
        """
        if ev is None or ev.cancelled:
            return False
        ev.cancelled = True
        return True

    @property
    def pending(self) -> int:
        """Heap size, cancelled-but-unswept events included."""
        return len(self._heap)

    @property
    def live_pending(self) -> int:
        """Events that will actually execute if reached."""
        return sum(1 for ev in self._heap if not ev.cancelled)

    def run(
        self,
        until: float = float("inf"),
        quiescent: Optional[Callable[[float], None]] = None,
        max_events: int = 10_000_000,
    ) -> float:
        """Drain events with time <= ``until``; returns final virtual time.

        A timestamp whose events were ALL cancelled advances nothing: the
        clock stays put, no batch is counted, quiescent does not fire.
        """
        while self._heap and self._heap[0].time <= until:
            t = self._heap[0].time
            ran = 0
            while self._heap and self._heap[0].time == t:
                ev = heapq.heappop(self._heap)
                if ev.cancelled:
                    self.events_cancelled += 1
                    continue
                self.now = t
                ran += 1
                self.events_run += 1
                if self.events_run > max_events:
                    raise RuntimeError("VirtualScheduler runaway: max_events exceeded")
                ev.action()
            if ran == 0:
                continue
            self.batches += 1
            if quiescent is not None:
                quiescent(t)
        return self.now
