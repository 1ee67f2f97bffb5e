"""Exporters: Perfetto/Chrome ``trace_event`` JSON + metrics JSON lines.

A span timeline is only useful if a human can open it. This module renders
the flight recorder's spans in the Chrome trace-event format (load the file
at https://ui.perfetto.dev or chrome://tracing):

* **request tracks** — every request is one thread (tid = rid) inside its
  tenant's process (pid = tenant index), so a request's ``queue`` →
  ``prefill`` → ``decode`` story reads left-to-right on one line and a
  tenant's requests stack into one swimlane group;
* **host tracks** — replica-level spans (``step``, ``migrate``) and scale
  events render under per-host processes (pid = HOST_PID_BASE + rid);
* **fleet track** — pid 0 carries fleet-scoped instants.

Timestamps are *virtual time* scaled by ``TS_SCALE`` (1 vtime unit = 1 ms
of trace time) — the causal order of the deterministic scheduler, not wall
clock. Spans become balanced B/E pairs (every ``B`` has its ``E``), instants
become ``i`` events, and every event's args carry ``tenant`` and ``replica``
labels; :func:`validate_trace_events` enforces exactly that schema plus
global ts monotonicity, and is what the CI smoke job runs against a real
recorded fleet scenario.

Metrics snapshots export as JSON lines — one object per profiler window
with a ``vtime`` stamp — so a scenario yields a timeline of every registry
series, not just final totals.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional

from repro_torch.obs.spans import INSTANT, Span

HOST_PID_BASE = 1_000_000  # host tracks live far above any tenant pid
TS_SCALE = 1000.0  # trace-event ts is in us; 1 vtime unit -> 1 ms


def _tenant_pids(spans: Iterable[Span]) -> Dict[str, int]:
    names = sorted({s.tenant for s in spans if s.trace >= 0})
    return {t: i + 1 for i, t in enumerate(names)}  # pid 0 is the fleet


def _track(span: Span, tenant_pids: Dict[str, int]):
    if span.trace >= 0:
        return tenant_pids.get(span.tenant, 0), span.trace
    if span.replica >= 0:
        return HOST_PID_BASE + span.replica, 0
    return 0, 0


def to_trace_events(spans: List[Span]) -> List[dict]:
    """Render finished spans as a ts-sorted trace-event list.

    Per track, spans are emitted in (t0, t1) order as adjacent B/E pairs;
    the final stable sort by ts interleaves tracks while preserving each
    track's B-before-E order at equal timestamps — so the output is both
    globally monotone in virtual time and balanced per track.
    """
    tenant_pids = _tenant_pids(spans)
    tracks: Dict[tuple, List[tuple]] = {}
    for idx, s in enumerate(spans):
        tracks.setdefault(_track(s, tenant_pids), []).append((s.t0, s.t1, idx, s))
    events: List[dict] = []
    for (pid, tid), items in sorted(tracks.items()):
        items.sort(key=lambda it: (it[0], it[1], it[2]))
        for t0, t1, _, s in items:
            args = {"tenant": s.tenant, "replica": s.replica, **s.args}
            common = {"name": s.name, "pid": pid, "tid": tid, "cat": "repro", "args": args}
            if s.kind == INSTANT:
                events.append({**common, "ph": "i", "s": "t", "ts": t0 * TS_SCALE})
            else:
                events.append({**common, "ph": "B", "ts": t0 * TS_SCALE})
                events.append({**common, "ph": "E", "ts": max(t1, t0) * TS_SCALE})
    events.sort(key=lambda e: e["ts"])  # stable: per-track order survives ties
    meta = [
        {"name": "process_name", "ph": "M", "pid": 0, "tid": 0, "ts": 0,
         "args": {"name": "fleet"}},
    ]
    for t, pid in sorted(tenant_pids.items()):
        meta.append({"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                     "ts": 0, "args": {"name": f"tenant:{t or 'default'}"}})
    for pid in sorted({e["pid"] for e in events if e["pid"] >= HOST_PID_BASE}):
        meta.append({"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                     "ts": 0, "args": {"name": f"host:{pid - HOST_PID_BASE}"}})
    return meta + events


def validate_trace_events(events: List[dict]) -> dict:
    """Schema gate for exported traces (the CI smoke contract).

    Raises ``ValueError`` on: non-monotone ts, unbalanced or misnested B/E
    on any (pid, tid) track, or a span/instant event missing the tenant or
    replica label. Returns summary counts on success.
    """
    stacks: Dict[tuple, List[str]] = {}
    last_ts = float("-inf")
    n_spans = n_instants = 0
    for i, e in enumerate(events):
        for field in ("name", "ph", "pid", "tid"):
            if field not in e:
                raise ValueError(f"event {i} missing {field!r}: {e}")
        if e["ph"] == "M":
            continue
        ts = e.get("ts")
        if ts is None:
            raise ValueError(f"event {i} missing ts: {e}")
        if ts < last_ts:
            raise ValueError(
                f"event {i} ts {ts} < previous {last_ts}: vtime not monotone"
            )
        last_ts = ts
        args = e.get("args", {})
        if "tenant" not in args or "replica" not in args:
            raise ValueError(f"event {i} lacks tenant/replica labels: {e}")
        key = (e["pid"], e["tid"])
        if e["ph"] == "B":
            stacks.setdefault(key, []).append(e["name"])
        elif e["ph"] == "E":
            stack = stacks.get(key, [])
            if not stack:
                raise ValueError(f"event {i}: E {e['name']!r} with empty stack on {key}")
            top = stack.pop()
            if top != e["name"]:
                raise ValueError(
                    f"event {i}: E {e['name']!r} closes B {top!r} on {key} (misnested)"
                )
            n_spans += 1
        elif e["ph"] == "i":
            n_instants += 1
        else:
            raise ValueError(f"event {i}: unexpected phase {e['ph']!r}")
    unbalanced = {k: v for k, v in stacks.items() if v}
    if unbalanced:
        raise ValueError(f"unbalanced B events at end of trace: {unbalanced}")
    return {
        "events": len(events),
        "spans": n_spans,
        "instants": n_instants,
        "tracks": len(stacks),
    }


def write_trace(path: str, events: List[dict]):
    """Chrome/Perfetto JSON object form (loadable as-is in the Perfetto UI)."""
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


def write_metrics(path: str, rows: List[dict]):
    """Metrics snapshots as JSON lines: one flat object per profiler window."""
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row, sort_keys=True) + "\n")


def read_trace(path: str) -> List[dict]:
    with open(path) as f:
        doc = json.load(f)
    return doc["traceEvents"] if isinstance(doc, dict) else doc
