"""Request-lifecycle span recorder: the fleet's flight data, bounded.

MemProf's tracing tool exists because counters alone cannot explain *when*
and *why* a page got hot (paper §6.2); the serving analogue is that fleet
totals cannot explain where a request's latency went. Every request gets a
trace id (its rid) at admission and emits spans — ``admit``, ``queue``,
``dispatch``, ``prefill``, ``decode``, ``migrate``, ``shed``/``complete`` —
stamped with *virtual time* from the fleet scheduler, so one diurnal
scenario produces one causally-ordered trace (exported to Perfetto by
obs/export.py).

Memory is bounded: the recorder is a ring buffer of ``capacity`` finished
spans. Under a million-request scenario the oldest spans fall off the ring
and ``dropped`` counts them — the drop count is itself a metric (the
FlightRecorder exports it as ``spans_dropped``), because a trace that
silently truncates is exactly the production blindness the paper warns
about. Open spans (begun, not yet ended) live in a dict keyed by
``(trace, name)`` and do not consume ring slots until they finish.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, Optional, Tuple

INSTANT = "instant"
SPAN = "span"


@dataclasses.dataclass
class Span:
    name: str
    trace: int  # request rid, or -1 for host/fleet-level spans
    t0: float  # virtual time
    t1: float  # == t0 for instants
    tenant: str = ""
    replica: int = -1
    kind: str = SPAN
    args: dict = dataclasses.field(default_factory=dict)

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


class SpanRecorder:
    def __init__(self, capacity: int = 65536):
        assert capacity > 0
        self.capacity = int(capacity)
        self.spans: Deque[Span] = deque()
        self.dropped = 0
        self.emitted = 0
        self.double_end = 0  # ends on an already-closed span (retry paths)
        self._open: Dict[Tuple[int, str], Span] = {}
        # recently-closed keys (bounded like the ring): lets ``end`` tell a
        # double-end apart from an end that never had a begin
        self._closed: set = set()
        self._closed_order: Deque[Tuple[int, str]] = deque()

    # ------------------------------------------------------------------
    def _push(self, span: Span):
        if len(self.spans) >= self.capacity:
            self.spans.popleft()
            self.dropped += 1
        self.spans.append(span)
        self.emitted += 1

    def begin(
        self,
        name: str,
        trace: int,
        t: float,
        tenant: str = "",
        replica: int = -1,
        **args,
    ):
        """Open a span; it enters the ring when ``end`` closes it. A repeated
        begin for the same (trace, name) replaces the open span (the older
        one is flushed as zero-length so it is never silently lost)."""
        key = (trace, name)
        prev = self._open.pop(key, None)
        if prev is not None:
            prev.t1 = prev.t0
            prev.args["truncated"] = True
            self._push(prev)
        self._open[key] = Span(name, trace, float(t), float(t), tenant, replica, SPAN, args)

    def _note_closed(self, key: Tuple[int, str]):
        if key in self._closed:
            return
        self._closed.add(key)
        self._closed_order.append(key)
        if len(self._closed_order) > self.capacity:
            self._closed.discard(self._closed_order.popleft())

    def end(self, name: str, trace: int, t: float, **args) -> Optional[Span]:
        """Close an open span at virtual time ``t``.

        Ending an already-closed span again — retry/re-dispatch paths do
        this when a failover and a late completion both try to close the
        same lifecycle span — records NOTHING and bumps the ``double_end``
        book: exactly one span per begin reaches the ring, and the open-
        span table is never corrupted by the second close. An end whose
        key was never begun (nor recently closed) is still recorded as an
        ``unmatched`` instant so a genuine lifecycle bug shows up in the
        trace instead of vanishing."""
        key = (trace, name)
        span = self._open.pop(key, None)
        if span is None:
            if key in self._closed:
                self.double_end += 1
                return None
            span = Span(name, trace, float(t), float(t), kind=INSTANT, args={"unmatched": True})
        span.t1 = float(t)
        span.args.update(args)
        self._note_closed(key)
        self._push(span)
        return span

    def instant(
        self,
        name: str,
        trace: int,
        t: float,
        tenant: str = "",
        replica: int = -1,
        **args,
    ):
        self._push(Span(name, trace, float(t), float(t), tenant, replica, INSTANT, args))

    def span(
        self,
        name: str,
        trace: int,
        t0: float,
        t1: float,
        tenant: str = "",
        replica: int = -1,
        **args,
    ):
        """Record an already-finished span in one call (engine-side use:
        the step that retires a request knows its whole decode range)."""
        self._push(Span(name, trace, float(t0), float(t1), tenant, replica, SPAN, args))

    # ------------------------------------------------------------------
    @property
    def open_count(self) -> int:
        return len(self._open)

    def finished(self) -> list:
        """Finished spans in emission order (ring contents)."""
        return list(self.spans)

    def drain_open(self, t: float):
        """Flush still-open spans at trace-export time (truncated runs):
        each closes at ``t`` and is tagged, so B/E events stay balanced."""
        for key in list(self._open):
            self.end(key[1], key[0], t, truncated=True)
