"""Fleet flight recorder: spans + metrics + exporters on one substrate.

This package is the reproduction's answer to MemProf's "always-on profiler
+ tracing tool" pairing (paper §3, §6.2): the engine already had the virtual-time
scheduler, the device counter plane, and the dispatch/sync budget books,
but their telemetry was ad-hoc ``stats()`` dicts — totals with no time
dimension, no per-request story, no export format. The flight recorder
threads one instrumentation substrate through admission, routing,
scheduling, elasticity, the serving engine, and the tiered-KV drain path:

* ``spans``   — request-lifecycle spans (admit/queue/dispatch/prefill/
  decode/migrate/shed/complete, plus per-chunk ``prefill_chunk`` spans
  under chunked prefill — the ``prefill`` span then covers admission to
  the prompt-completing chunk, labeled with its chunk count) stamped with
  scheduler virtual time, in a ring buffer with a drop counter (bounded
  under million-request runs);
* ``metrics`` — typed counters/gauges/exponential histograms with tenant +
  replica label dimensions and an exact fleet ``merge``; device-side series
  enter ONLY from ``drain_counters()`` deltas, so the decode hot path stays
  at one dispatch and zero mandatory host syncs per step and the
  drain-cadence invariant extends to every metric. Engines record a
  per-tenant ``ttft`` histogram (submit -> first generated token, virtual
  time; the prompt-completing chunk step under chunked prefill), merged
  into ``tenant_report``'s ``ttft_p50``/``ttft_p99``;
* ``export``  — Perfetto/Chrome trace_event JSON for the span timeline and
  JSON-lines metric snapshots per profiler window;
* ``timeline`` — each serving engine's device timeline: its step phases
  (admission, the prefills and the model call inside each, the decode's
  replay or the chunk columns, the tier lookup and writes, the host books,
  the placement-window boundary's drain, plan, migrations and prefetch
  window) and each request's ``queue`` wait and ``prefill``, on the host
  clock (``time.perf_counter`` seconds). On the card the points are CUDA
  events, mapped onto the host clock at the waits the engine makes anyway
  (a whole-slot prefill's first token, the counter plane's drain), so the
  timeline adds no host sync; a host-only span (one that launches nothing)
  measures the idle its host work leaves the device. It is kept apart from
  the span ring and the registries above, which stay the reference's.

:class:`FlightRecorder` is the facade the fleet attaches
(``FleetRouter.attach_recorder`` / ``build_fleet(recorder=...)``); a
process-global default recorder can be installed explicitly
(:func:`set_default_recorder`, what ``benchmarks/run.py --trace`` does) or
via the strict boolean env ``REPRO_FLIGHT_RECORDER=1`` (what CI uses to run
the dispatch-budget suite with tracing on).

A recorder, to an engine, is anything with ``register``, ``span`` and
``instant``: the engine calls nothing else on it. An engine's device
timeline is on exactly while a recorder is attached to it (the
constructor's ``recorder=``, the default recorder, or a fleet's attach),
and the engine hands the timeline over through ``register``;
``FlightRecorder.write`` renders every timeline handed to it, apart from
the span timeline, as ``<trace>.device.json`` on the wall clock. The
whole-slot ``prefill`` span reaches the recorder after the request's first
token is back on the host, outside every host-only span, so a recorder
may act on the device there; elsewhere its calls should launch nothing.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.env import env_flag
from repro_torch.obs import export as export_mod
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricSnapshot,
    MetricsRegistry,
    merge_snapshots,
    merged_histogram,
    prefetch_report,
    sum_counters,
)
from repro_torch.obs.spans import Span, SpanRecorder
from repro_torch.obs.timeline import DeviceTimeline, trace_events

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricSnapshot",
    "MetricsRegistry",
    "merge_snapshots",
    "merged_histogram",
    "prefetch_report",
    "sum_counters",
    "Span",
    "SpanRecorder",
    "FlightRecorder",
    "default_recorder",
    "set_default_recorder",
]

_ENV_FLAG = "REPRO_FLIGHT_RECORDER"


class FlightRecorder:
    """Spans + a fleet-level registry + every attached engine registry.

    ``now_fn`` is set by whatever owns the clock (the FleetRouter points it
    at fleet virtual time; a standalone engine at its step counter), so all
    emission points share one causal timeline. ``metrics_window`` sets the
    vtime cadence of metric snapshots (the JSONL export rows).
    """

    def __init__(
        self,
        capacity: int = 65536,
        metrics_window: float = 16.0,
        step_spans: bool = True,
    ):
        self.spans = SpanRecorder(capacity)
        self.metrics = MetricsRegistry()
        self.extra_registries: List[MetricsRegistry] = []
        # engines' device timelines: exported apart, never merged
        self.timelines: List[DeviceTimeline] = []
        self.metrics_window = float(metrics_window)
        self.metric_rows: List[dict] = []
        self.step_spans = bool(step_spans)  # per-replica step spans on host tracks
        self.now_fn = lambda: 0.0
        self._last_window: Optional[float] = None

    # ------------------------------------------------------------------
    def now(self) -> float:
        return float(self.now_fn())

    def register(self, registry):
        """Include an engine/replica registry in snapshots and exports, or an
        engine's device timeline in ``write``'s device file."""
        if isinstance(registry, DeviceTimeline):
            if registry not in self.timelines:
                self.timelines.append(registry)
        elif registry is not self.metrics and registry not in self.extra_registries:
            self.extra_registries.append(registry)

    # span API (t defaults to the shared virtual clock) ----------------
    def begin(self, name, trace, t=None, **kw):
        self.spans.begin(name, trace, self.now() if t is None else t, **kw)

    def end(self, name, trace, t=None, **kw):
        return self.spans.end(name, trace, self.now() if t is None else t, **kw)

    def instant(self, name, trace, t=None, **kw):
        self.spans.instant(name, trace, self.now() if t is None else t, **kw)

    def span(self, name, trace, t0, t1, **kw):
        self.spans.span(name, trace, t0, t1, **kw)

    # metrics snapshots -------------------------------------------------
    def on_step(self, now: float):
        """FleetRouter hook: snapshot the registries once per window."""
        if self._last_window is None:
            self._last_window = now
            return
        if now - self._last_window >= self.metrics_window:
            self._last_window = now
            self.snapshot_metrics(now)

    def merged_snapshot(self) -> MetricSnapshot:
        self.metrics.gauge("spans_dropped").set(self.spans.dropped)
        self.metrics.gauge("spans_emitted").set(self.spans.emitted)
        self.metrics.gauge("spans_double_end").set(self.spans.double_end)
        return merge_snapshots(
            [self.metrics.snapshot()] + [r.snapshot() for r in self.extra_registries]
        )

    def snapshot_metrics(self, now: float) -> dict:
        row = {"vtime": float(now), **self.merged_snapshot().flat()}
        self.metric_rows.append(row)
        return row

    # export ------------------------------------------------------------
    def trace_events(self, drain_open: bool = True) -> List[dict]:
        if drain_open:
            self.spans.drain_open(self.now())
        return export_mod.to_trace_events(self.spans.finished())

    def validate(self) -> dict:
        return export_mod.validate_trace_events(self.trace_events())

    def write(
        self,
        trace_path: str,
        metrics_path: Optional[str] = None,
        validate: bool = True,
    ) -> dict:
        """Export the span timeline (and final metrics row) to disk, and the
        registered engines' device timelines to ``<trace_path>.device.json``.

        ``metrics_path`` defaults to ``<trace_path>.metrics.jsonl``. Returns
        the validator's summary so callers can assert on it.
        ``validate=False`` skips the schema gate — for traces that span
        several independent scenarios (benchmarks/run.py over the whole
        suite), where unrelated fleets reuse rids on one timeline.
        """
        events = self.trace_events()
        if validate:
            summary = export_mod.validate_trace_events(events)
        else:
            summary = {"events": len(events)}
        export_mod.write_trace(trace_path, events)
        if self.timelines:
            device = trace_events(self.timelines)
            if validate:
                export_mod.validate_trace_events(device)
            export_mod.write_trace(f"{trace_path}.device.json", device)
        self.snapshot_metrics(self.now())
        export_mod.write_metrics(
            metrics_path or f"{trace_path}.metrics.jsonl", self.metric_rows
        )
        return summary


_DEFAULT: Optional[FlightRecorder] = None


def set_default_recorder(rec: Optional[FlightRecorder]):
    """Install (or clear, with None) the process-global recorder that
    engines and routers attach when not given one explicitly."""
    global _DEFAULT
    _DEFAULT = rec


def default_recorder() -> Optional[FlightRecorder]:
    """The global recorder, if any: one installed via
    :func:`set_default_recorder` (``benchmarks/run.py --trace``), else a
    lazily created singleton when ``REPRO_FLIGHT_RECORDER=1``."""
    global _DEFAULT
    if _DEFAULT is None and env_flag(_ENV_FLAG, default=False):
        _DEFAULT = FlightRecorder()
    return _DEFAULT
