"""A serving engine's device timeline: where each step's time goes, on the
device's own clock.

The flight recorder's spans (``obs/spans.py``) are stamped in virtual time,
the causal order of the fleet's scheduler. This timeline stamps the engine's
phases (admission, the prefills, the decode's replay, the tier lookup and
writes, the host books, the placement-window boundary) and each request's
wait and prefill, on the host clock: ``time.perf_counter`` seconds.

Clock. On a CUDA device a point of the timeline is a CUDA event, recorded on
the engine's stream where a phase starts or ends; it completes when the
device reaches it, so a span between two points is device time. Points map
onto the host clock through an anchor: an event recorded right after the
engine waited for the device (a host read it makes anyway), paired with the
host time taken just before it. The device then has (almost) nothing
queued, so the two clocks agree to within the microseconds the event takes
to complete. Every such wait takes a new anchor and completes every point
recorded before it, and the anchor before; those points are read against
that anchor later (:meth:`DeviceTimeline.settle`), right before the
engine's next wait, while the host would block anyway: reads there
neither lengthen the idle a wait leaves nor hold the host back while the
device has work queued (under a profiler an event's read can wait for the
device). No synchronize and no host copy is added, and
:meth:`DeviceTimeline.read` reads only the points the device reports
complete. On the CPU every op has finished when it returns, and a point is
the host clock itself.

Host-only spans. A span marked ``host_only`` encloses no launch, so its two
points are events with nothing enqueued between them: its device length is
the time the device sat idle waiting on that stretch of host work (none
where the device still had queued work to run through). While a
``torch.profiler`` runs, such a span is also a ``serve.<name>`` range, so
the profiler's idle gaps carry the phase's name; no range encloses a
launch, so none is projected onto the device.

Bounded: finished spans land in a :class:`SpanRecorder` ring with its drop
count, and events come from a pool they return to once read; an engine
that never waits holds at most ``_MAX_UNREAD`` of them, and drops the
spans it cannot place.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.obs.spans import Span, SpanRecorder

_NULL = contextlib.nullcontext()
# points held unread at most: an engine that never waits (chunked, without
# device tiering) gives no anchor, so past this the points the device has
# passed are read against one if there is one, else dropped with their spans
_MAX_UNREAD = 8192


@dataclasses.dataclass
class DeviceSpan(Span):
    """A timeline span: numbered, with its parent's number (-1: none), and
    whether its stretch launched nothing on the device."""

    sid: int = -1
    parent: int = -1
    host_only: bool = False


class _Mark:
    """A CUDA event on the timeline, read onto the host clock once the
    device has passed it."""

    __slots__ = ("event", "seq", "host")

    def __init__(self, event, seq: int, host: Optional[float] = None):
        self.event, self.seq, self.host = event, seq, host


def _host(point) -> Optional[float]:
    return point.host if isinstance(point, _Mark) else point


class _Open:
    __slots__ = ("name", "trace", "sid", "parent", "t0", "t1", "host_only", "args", "rng")

    def __init__(self, name, trace, sid, parent, t0, host_only, args):
        self.name, self.trace, self.sid, self.parent = name, trace, sid, parent
        self.t0, self.t1, self.host_only, self.args, self.rng = t0, None, host_only, args, None


class DeviceTimeline:
    """Spans of one engine on its device's clock (module docstring).

    Phases nest: :meth:`phase` (or :meth:`enter` / :meth:`leave`) opens a
    span under the innermost open one. A request's spans that outlive the
    code that opens them (its wait in the queue, a chunked prefill) are
    keyed by (trace, name): :meth:`open` and :meth:`close`.
    """

    on = True

    def __init__(self, device, capacity: int = 65536):
        self.device = torch.device(device)
        self.spans = SpanRecorder(capacity)
        # the host clock's offset to the wall clock, for exports
        self.wall_offset = time.time() - time.perf_counter()
        self._card = self.device.type == "cuda"
        self._stack: List[_Open] = []
        self._keyed: Dict[Tuple[int, str], _Open] = {}
        self._ended: deque = deque()  # ended spans with a point not yet read
        self._marks: List[_Mark] = []  # recorded, not yet read, in order
        self._pool: list = []
        self._anchor: Optional[_Mark] = None  # the last wait's
        self._ref: Optional[_Mark] = None  # the one before, complete
        self._ready = 0  # points recorded before the last wait, read against _ref
        self._seq = 0
        self._sid = 0

    # -- points -----------------------------------------------------------
    def _event(self):
        ev = self._pool.pop() if self._pool else torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        self._seq += 1
        return ev

    def mark(self):
        """A point on the timeline now: the host clock on the CPU, a CUDA
        event on the card."""
        if not self._card:
            return time.perf_counter()
        if len(self._marks) >= _MAX_UNREAD and (self._anchor is None or self._anchor.event.query()):
            self._read(self._anchor, self._complete())
        m = _Mark(self._event(), self._seq)
        self._marks.append(m)
        return m

    def waited(self) -> float:
        """Call right after the engine waited for the device: every point
        recorded so far has completed, and so has the previous anchor,
        against which :meth:`settle` will read them; take a new anchor.
        Returns the host time."""
        waited = time.perf_counter()
        if not self._card:
            return waited
        if self._anchor is not None:
            if self._ref is not None:
                self._pool.append(self._ref.event)
            self._ref, self._ready = self._anchor, len(self._marks)
        self._anchor = _Mark(self._event(), self._seq, time.perf_counter())
        return waited

    def settle(self):
        """Read the points the last wait completed; call it right before the
        engine waits for the device again."""
        if self._ready:
            self._read(self._ref, self._ready)

    def _complete(self) -> int:
        """How many of the oldest unread points the device has passed."""
        n = 0
        while n < len(self._marks) and self._marks[n].event.query():
            n += 1
        return n

    def _read(self, anchor: Optional[_Mark], n: int):
        """Read the first ``n`` points against ``anchor`` (both complete);
        with no anchor, drop them (their spans are dropped)."""
        for m in self._marks[:n]:
            if anchor is None:
                m.host = math.nan
            elif m.seq > anchor.seq:
                m.host = anchor.host + 1e-3 * anchor.event.elapsed_time(m.event)
            else:
                m.host = anchor.host - 1e-3 * m.event.elapsed_time(anchor.event)
            self._pool.append(m.event)
            m.event = None
        del self._marks[:n]
        self._ready = max(0, self._ready - n)
        waiting = deque()
        for sp in self._ended:
            if self._done(sp):
                self._push(sp)
            else:
                waiting.append(sp)
        self._ended = waiting

    # -- spans ------------------------------------------------------------
    def _parent(self) -> int:
        return self._stack[-1].sid if self._stack else -1

    def _new(self, name, trace, at, host_only, args) -> _Open:
        self._sid += 1
        return _Open(name, int(trace), self._sid, self._parent(), self.mark() if at is None else at,
                     host_only, args)

    def enter(self, name: str, trace: int = -1, host_only: bool = False, at=None, **args) -> _Open:
        """Open a phase under the innermost open one, starting now (or at
        the point ``at``)."""
        sp = self._new(name, trace, at, host_only, args)
        self._stack.append(sp)
        if host_only and torch.autograd._profiler_enabled():
            sp.rng = torch.profiler.record_function(f"serve.{name}")
            sp.rng.__enter__()
        return sp

    def leave(self, sp: _Open, at=None, **args):
        """Close the phase ``sp`` (and any left open inside it), now or at
        the point ``at``."""
        while self._stack:
            top = self._stack.pop()
            if top.rng is not None:
                top.rng.__exit__(None, None, None)
            if top is sp:
                break
        sp.args.update(args)
        self._end(sp, at)

    @contextlib.contextmanager
    def phase(self, name: str, trace: int = -1, host_only: bool = False, **args):
        sp = self.enter(name, trace, host_only, **args)
        try:
            yield sp
        finally:
            self.leave(sp)

    def open(self, name: str, trace: int, at=None, **args):
        """Open a keyed span, (trace, name), under the innermost phase."""
        self._keyed[(int(trace), name)] = self._new(name, trace, at, False, args)

    def close(self, name: str, trace: int, at=None, **args):
        """Close the keyed span (trace, name), if open."""
        sp = self._keyed.pop((int(trace), name), None)
        if sp is not None:
            sp.args.update(args)
            self._end(sp, at)

    def forget(self, trace: int):
        """Drop the keyed spans of ``trace`` (an aborted request)."""
        for key in [k for k in self._keyed if k[0] == trace]:
            del self._keyed[key]

    def _end(self, sp: _Open, at):
        sp.t1 = self.mark() if at is None else at
        if self._done(sp):
            self._push(sp)
        else:
            self._ended.append(sp)

    @staticmethod
    def _done(sp: _Open) -> bool:
        return _host(sp.t0) is not None and _host(sp.t1) is not None

    def _push(self, sp: _Open):
        t0, t1 = _host(sp.t0), _host(sp.t1)
        if math.isnan(t0) or math.isnan(t1):
            self.spans.dropped += 1
            return
        self.spans._push(DeviceSpan(sp.name, sp.trace, t0, t1, args=sp.args, sid=sp.sid,
                                    parent=sp.parent, host_only=sp.host_only))

    # -- reading ----------------------------------------------------------
    def read(self, t0: float = float("-inf"), t1: float = float("inf")) -> List[DeviceSpan]:
        """The finished spans that end between host times ``t0`` and ``t1``,
        by start, after reading every point the device reports complete
        (``Event.query``: no wait)."""
        self.settle()
        if self._anchor is not None and self._marks and self._anchor.event.query():
            self._read(self._anchor, self._complete())
        out = [s for s in self.spans.finished() if t0 <= s.t1 <= t1]
        out.sort(key=lambda s: (s.t0, s.sid))
        return out

    def counters(self) -> dict:
        """Spans emitted to and dropped from the ring (or unplaced), and the
        points recorded and not yet read; the device file carries them."""
        return {
            "spans_emitted": self.spans.emitted,
            "spans_dropped": self.spans.dropped,
            "events_in_flight": len(self._marks) + (self._anchor is not None),
        }


def trace_events(timelines: List[DeviceTimeline]) -> List[dict]:
    """Perfetto/Chrome trace events of the timelines' finished spans on the
    wall clock, in us: timeline ``i`` is process ``i`` (``replica`` in the
    args), its step phases thread 0 and request ``rid``'s spans thread
    ``rid + 1``. Each track's spans nest as their parents say (a span whose
    parent is on another track, or not read, is a root there), as balanced
    B/E pairs; a point is clamped into its parent's span and after its
    previous sibling's end, which moves it at most by the jitter of the
    clock mapping. Each process's labels carry its ``counters``, so a file
    cut short by the ring says so. Checked by
    ``export.validate_trace_events``."""
    events, meta = [], []
    for i, tl in enumerate(timelines):
        spans = tl.read()
        c = tl.counters()
        meta.append({"name": "process_name", "ph": "M", "pid": i, "tid": 0, "ts": 0,
                     "args": {"name": f"engine:{i}"}})
        meta.append({"name": "process_labels", "ph": "M", "pid": i, "tid": 0, "ts": 0,
                     "args": {"labels": ", ".join(f"{k}={v}" for k, v in c.items()), **c}})
        tracks: Dict[int, List[DeviceSpan]] = {}
        for sp in spans:
            tracks.setdefault(sp.trace + 1, []).append(sp)
        for tid, track in sorted(tracks.items()):
            meta.append({"name": "thread_name", "ph": "M", "pid": i, "tid": tid, "ts": 0,
                         "args": {"name": "steps" if tid == 0 else f"rid:{tid - 1}"}})
            sids = {sp.sid for sp in track}
            kids: Dict[int, List[DeviceSpan]] = {}
            for sp in track:  # by start (``read``'s order)
                kids.setdefault(sp.parent if sp.parent in sids else -1, []).append(sp)
            off = tl.wall_offset

            def emit(sp: DeviceSpan, lo: float, hi: float) -> float:
                t0 = min(max(sp.t0 + off, lo), hi)
                t1 = min(max(sp.t1 + off, t0), hi)
                args = {"tenant": sp.tenant, "replica": i, **sp.args, "parent": sp.parent,
                        "host_only": sp.host_only}
                common = {"name": sp.name, "pid": i, "tid": tid, "cat": "repro", "args": args}
                events.append({**common, "ph": "B", "ts": t0 * 1e6})
                at = t0
                for kid in kids.get(sp.sid, ()):
                    at = emit(kid, at, t1)
                events.append({**common, "ph": "E", "ts": t1 * 1e6})
                return t1

            at = float("-inf")
            for root in kids.get(-1, ()):
                at = emit(root, at, float("inf"))
    events.sort(key=lambda e: e["ts"])  # stable: each track's order survives ties
    return meta + events


class _Off:
    """The timeline of an engine with no recorder: records nothing and
    allocates nothing."""

    on = False

    def mark(self):
        return None

    def waited(self):
        return None

    def enter(self, *args, **kw):
        return None

    def leave(self, *args, **kw):
        pass

    def phase(self, *args, **kw):
        return _NULL

    def open(self, *args, **kw):
        pass

    def close(self, *args, **kw):
        pass

    def forget(self, trace):
        pass

    def settle(self):
        pass


OFF = _Off()
