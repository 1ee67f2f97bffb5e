"""The serving engine's device timeline (``obs/timeline.py``), on the CPU at
reduced size, whole-slot and chunked, dense and moe: the span tree of a
step, each request's ``queue`` -> ``prefill`` -> ``prefill.model``, the
chunked prefill's end at its emitting column, host-only spans that run no
op, the ring's bound, the device file ``FlightRecorder.write`` adds, and
an engine with no recorder recording nothing.

Two tests run on the card (marked ``cuda``; this file imports no JAX):

    python -m pytest -q --noconftest -m cuda tests/test_torch_serving_timeline.py
"""
import dataclasses
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.workloads import get_profile  # noqa: E402
from repro_torch.data.requests import RequestGenerator  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.obs import FlightRecorder, set_default_recorder  # noqa: E402
from repro_torch.obs.export import read_trace, validate_trace_events  # noqa: E402
from repro_torch.obs import timeline as timeline_mod  # noqa: E402
from repro_torch.obs.timeline import OFF, DeviceTimeline  # noqa: E402
from repro_torch.runtime.serving import EngineConfig, ServingEngine  # noqa: E402

ARCHS = ["smollm-360m", "granite-moe-3b-a800m"]  # dense, moe
STEP_PHASES = ["admit", "decode", "books", "lookup", "books", "retire", "write", "books"]
N_REQUESTS = 6


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ARCHS:
        api = get_model(get_config(arch).reduced())
        out[arch] = (api, api.init(0, device="cpu"))
    return out


def _engine(api, model, recorder, device="cpu", **over):
    kw = dict(max_batch=4, max_len=64, n_pages=256, near_frac=0.02, placement_window=4,
              device_tiering=True, prefetch_promote=True)
    kw.update(over)
    return ServingEngine(api, model, EngineConfig(**kw), seed=0, recorder=recorder, device=device)


def _submit(eng, n=N_REQUESTS):
    prof = dataclasses.replace(get_profile("Web1"), prompt_mean=24, decode_mean=8,
                               prefix_share=0.5, n_prefixes=2)
    gen = RequestGenerator(prof, vocab_size=eng.cfg.vocab_size, seed=0)
    for _ in range(n):
        eng.submit(next(gen))


def _drive(eng, max_steps=200):
    while (eng.queue or any(s.active for s in eng.slots)) and eng.engine_steps < max_steps:
        eng.step()


def _children(spans, parent):
    return sorted((s for s in spans if s.parent == parent.sid), key=lambda s: (s.t0, s.sid))


@pytest.mark.parametrize("arch", ARCHS)
def test_whole_slot_step_tree(models, arch):
    """The first step: ``step`` holds admit, decode, books, lookup, books,
    retire, write, books in that order; admit holds each admission's
    host-only bookkeeping and its request's prefill, and each prefill its
    model call. Every request's queue ends where its prefill starts, and a
    prefill has positive length and contains its model call."""
    eng = _engine(*models[arch], FlightRecorder())
    _submit(eng)
    eng.step()
    spans = eng.timeline()
    step = next(s for s in spans if s.name == "step")
    assert step.parent == -1 and not step.host_only
    kids = _children(spans, step)
    assert [s.name for s in kids] == STEP_PHASES
    assert [s.host_only for s in kids] == [False, False, True, False, True, True, False, True]
    assert all(step.t0 <= s.t0 <= s.t1 <= step.t1 for s in kids)
    assert all(a.t1 <= b.t0 for a, b in zip(kids, kids[1:]))
    admit = kids[0]
    inner = _children(spans, admit)
    assert [s.name for s in inner] == ["admit.host", "prefill"] * 4
    assert [s.trace for s in inner if s.name == "prefill"] == [0, 1, 2, 3]
    assert all(s.host_only == (s.name == "admit.host") for s in inner)
    queues = {s.trace: s for s in spans if s.name == "queue"}
    assert sorted(queues) == [0, 1, 2, 3]  # the two still queued have no span yet
    for pre in (s for s in inner if s.name == "prefill"):
        (model,) = _children(spans, pre)
        assert model.name == "prefill.model" and model.trace == pre.trace
        assert pre.dur > 0 and pre.t0 <= model.t0 <= model.t1 <= pre.t1
        assert queues[pre.trace].t1 == pre.t0 and queues[pre.trace].parent == -1
    assert step.args["prefills"] == 4


def test_epoch_and_every_request(models):
    """Run to the end: every request has one queue, prefill and model span;
    each placement-window boundary's epoch holds drain, plan, migrate and
    prefetch; the recorder holds the timeline apart from its registries."""
    rec = FlightRecorder()
    eng = _engine(*models["smollm-360m"], rec)
    _submit(eng)
    _drive(eng)
    spans = eng.timeline()
    for name in ("queue", "prefill", "prefill.model"):
        assert sorted(s.trace for s in spans if s.name == name) == list(range(N_REQUESTS))
    epochs = [s for s in spans if s.name == "epoch"]
    assert len(epochs) == eng.engine_steps // 4
    for ep in epochs:
        names = [s.name for s in _children(spans, ep)]
        assert names[:3] == ["drain", "plan", "migrate"] and names[-1] == "prefetch"
    steps = [s for s in spans if s.name == "step"]
    assert len(steps) == eng.engine_steps
    assert sum(s.args["prefills"] for s in steps) == N_REQUESTS
    assert rec.timelines == [eng._timeline] and eng._timeline not in rec.extra_registries


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_ends_at_its_emitting_column(models, arch):
    """Chunked: admission closes the queue and opens the prefill at one
    point; a step runs ``columns`` in place of ``decode``; the prefill ends
    right after the column that emitted the request's first token."""
    eng = _engine(*models[arch], FlightRecorder(), prefill_chunk=8)
    orig = eng._dispatch
    log = []  # each dispatch: (host clock before, after, the rids whose first token it emits)

    def dispatch(name):
        col = int(eng._bufs["col"][0]) if name == "column" else -1
        rids = [eng.slots[i].seq_id for i, (start, end) in eng._step_chunks.items()
                if end == eng.slots[i].chunk.total and col == end - start - 1]
        t0 = time.perf_counter()
        orig(name)
        log.append((t0, time.perf_counter(), rids))

    eng._dispatch = dispatch
    _submit(eng)
    eng.step()
    spans = eng.timeline()
    step = next(s for s in spans if s.name == "step")
    # no page completed and no token decoded yet: nothing to write
    assert [s.name for s in _children(spans, step)] == ["admit", "columns", "books", "lookup", "books",
                                                         "retire", "books"]
    _drive(eng)
    spans = eng.timeline()
    prefills = {s.trace: s for s in spans if s.name == "prefill"}
    queues = {s.trace: s for s in spans if s.name == "queue"}
    admits = {s.sid: s for s in spans if s.name == "admit"}
    assert sorted(prefills) == sorted(r for _, _, rids in log for r in rids) == list(range(N_REQUESTS))
    for rid, pre in prefills.items():
        j = next(j for j, (_, _, rids) in enumerate(log) if rid in rids)
        assert log[j][1] <= pre.t1 <= (log[j + 1][0] if j + 1 < len(log) else float("inf"))
        assert queues[rid].t1 == pre.t0 and pre.parent in admits and pre.dur > 0
    assert not any(s.name in ("prefill.model", "decode") and s.trace >= 0 for s in spans)


class _Ops(TorchDispatchMode):
    """The host clock at every op the dispatcher runs."""

    def __init__(self):
        super().__init__()
        self.at = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.at.append(time.perf_counter())
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("chunk", [0, 8])
def test_host_only_spans_run_no_op(models, chunk):
    """No op (on the CPU engine, what would be a launch on the card) runs
    inside a host-only span, and the kernel wrappers' launch counts do not
    move across one; the phases that launch do run ops."""
    eng = _engine(*models["granite-moe-3b-a800m"], FlightRecorder(), prefill_chunk=chunk)
    _submit(eng)
    before = launch_counts()
    with _Ops() as ops:
        _drive(eng, max_steps=12)
    assert launch_counts() == before
    spans = eng.timeline()
    host = [s for s in spans if s.host_only]
    assert {s.name for s in host} == {"admit.host", "books", "retire", "plan"}
    assert not [s.name for s in host if any(s.t0 < t < s.t1 for t in ops.at)]
    for name in ("lookup", "write", "columns" if chunk else "prefill.model"):
        assert any(s.t0 < t < s.t1 for s in spans if s.name == name for t in ops.at), name


def test_ring_bound_and_drop_count():
    tl = DeviceTimeline("cpu", capacity=8)
    for i in range(20):
        with tl.phase("step"):
            with tl.phase("books", host_only=True):
                pass
    c = tl.counters()
    assert len(tl.read()) == 8 and c["spans_dropped"] == 32 and c["spans_emitted"] == 40
    assert c["events_in_flight"] == 0
    assert [s.name for s in tl.read()] == ["step", "books"] * 4
    # the device file says the ring dropped spans, and nests what is left
    events = timeline_mod.trace_events([tl])
    (labels,) = [e for e in events if e["name"] == "process_labels"]
    assert labels["args"]["spans_dropped"] == 32 and "spans_dropped=32" in labels["args"]["labels"]
    assert validate_trace_events(events)["spans"] == 8


def test_device_file_nests_by_parent():
    """Spans that share an end, a child whose mapped point falls a little
    outside its parent, and a request's spans under a step phase each
    render as balanced, nested B/E pairs on their own track."""
    tl = DeviceTimeline("cpu")
    tl.wall_offset = 0.0
    step = tl.enter("step", at=1.0)
    admit = tl.enter("admit", at=1.0)
    tl.open("queue", 7, at=0.5)
    tl.close("queue", 7, at=2.0)
    tl.leave(admit, at=2.0)
    books = tl.enter("books", host_only=True, at=2.0)
    tl.leave(books, at=2.5)  # past its parent's end by the mapping's jitter
    tl.leave(step, at=2.0)
    events = timeline_mod.trace_events([tl])
    assert validate_trace_events(events)["spans"] == 4
    spans = [(e["ph"], e["name"], e["tid"], e["ts"]) for e in events if e["ph"] in "BE"]
    assert [x for x in spans if x[2] == 0] == [
        ("B", "step", 0, 1e6), ("B", "admit", 0, 1e6), ("E", "admit", 0, 2e6),
        ("B", "books", 0, 2e6), ("E", "books", 0, 2e6), ("E", "step", 0, 2e6)]
    assert [x for x in spans if x[2] == 8] == [("B", "queue", 8, 0.5e6), ("E", "queue", 8, 2e6)]
    threads = {e["tid"]: e["args"]["name"] for e in events if e["name"] == "thread_name"}
    assert threads == {0: "steps", 8: "rid:7"}


class _FakeCard:
    """The card path's clocks, driven by a test: an event records the
    device time at which the device reaches it (the host clock plus the
    work queued ahead of it) and is complete once the device is there."""

    def __init__(self, monkeypatch):
        self.host, self.queued, self.device_now, self.created = 0.0, 0.0, float("-inf"), 0
        monkeypatch.setattr(timeline_mod.torch.cuda, "Event", self.event)
        monkeypatch.setattr(timeline_mod.torch.cuda, "current_stream", lambda *a: None)
        monkeypatch.setattr(timeline_mod.time, "perf_counter", lambda: self.host)

    def event(self, enable_timing=True):
        self.created += 1
        card = self

        class Event:
            def record(self, stream=None):
                self.t = card.host + card.queued

            def query(self):
                return card.device_now >= self.t

            def elapsed_time(self, other):
                assert self.query() and other.query(), "an event read before it completed"
                return 1e3 * (other.t - self.t)

        return Event()


def test_card_points_map_through_anchors(monkeypatch):
    """On the card a span's points are device times, read onto the host
    clock through the anchor a wait takes: points recorded before the first
    anchor (read backwards from it) and after it (forwards), by ``read``
    (what the device reports complete) or by ``settle`` (what the last wait
    completed); the events return to the pool and are reused."""
    card = _FakeCard(monkeypatch)
    tl = DeviceTimeline("cuda")
    card.queued = 0.5  # the device runs 0.5 s behind the host
    with tl.phase("a"):
        card.host = 0.1
    card.host, card.queued, card.device_now = 1.0, 0.0, 1.0  # a wait: the device caught up
    tl.waited()
    assert [(s.name, s.t0, s.t1) for s in tl.read()] == [("a", 0.5, 0.6)]
    card.host, card.queued = 1.1, 0.2
    with tl.phase("b"):
        card.host = 1.3
    card.host, card.queued, card.device_now = 2.0, 0.0, 2.0
    tl.waited()
    assert len(tl.spans.finished()) == 1  # b's points are read by settle, not by the wait
    tl.settle()
    assert [(s.name, s.t0, s.t1) for s in tl.spans.finished()] == [("a", 0.5, 0.6), ("b", 1.3, 1.5)]
    created = []
    for _ in range(20):
        with tl.phase("c"):
            card.host += 0.01
        card.device_now = card.host
        tl.settle()
        tl.waited()
        created.append(card.created)
    assert created[5] == created[-1] and tl.counters()["events_in_flight"] <= 4
    assert len(tl.read()) == 22


def test_card_points_stay_bounded_without_a_wait(monkeypatch):
    """An engine that never waits takes no anchor: past the bound, the
    points the device has passed are dropped with their spans."""
    card = _FakeCard(monkeypatch)
    monkeypatch.setattr(timeline_mod, "_MAX_UNREAD", 64)
    card.device_now = float("inf")
    tl = DeviceTimeline("cuda")
    for _ in range(500):
        with tl.phase("step"):
            card.host += 0.001
    assert len(tl._marks) <= 64 and card.created <= 66
    assert tl.read() == [] and tl.counters()["spans_dropped"] >= 400


@pytest.mark.parametrize("shards", [0, 2])
def test_plane_dirty_says_whether_the_drain_reads(shards):
    """The engine takes an anchor after a drain only where the store says
    the drain reads its plane back: a dirty plane once, a clean one never."""
    from repro_torch.device import HOST_READS
    from repro_torch.runtime.sharded import ShardedTieredKV
    from repro_torch.runtime.tiered_kv import TieredKVCache

    kw = dict(identity_scales=True, counter_slots=2, device="cpu")
    store = ShardedTieredKV(16, 8, 6, shards, **kw) if shards else TieredKVCache(16, 8, 6, **kw)
    store.write(np.arange(16), torch.zeros((16, 8)))
    ids = np.arange(0, 16, 2)
    for _ in range(2):
        assert not store.plane_dirty
        store.lookup_segments(ids, np.zeros(ids.size, np.int32), 2, slot_idx=[0], tenant_idx=[0],
                              role_idx=[0])
        for dirty in (True, False):
            assert store.plane_dirty == dirty
            reads = HOST_READS["copies"]
            store.drain_counters()
            assert (HOST_READS["copies"] > reads) == dirty


def test_no_recorder_records_nothing(models, monkeypatch):
    monkeypatch.delenv("REPRO_FLIGHT_RECORDER", raising=False)
    set_default_recorder(None)
    api, model = models["smollm-360m"]
    eng = _engine(api, model, None)
    _submit(eng)
    _drive(eng)
    assert eng.recorder is None and eng._tl is OFF and eng._timeline is None
    assert eng.timeline() == []


def test_attach_later_and_write_the_device_file(models, tmp_path):
    """A recorder attached to a running engine turns its timeline on; write
    renders it as a valid Perfetto file on the wall clock beside the span
    trace, the step phases on one thread, each request on its own."""
    api, model = models["smollm-360m"]
    eng = _engine(api, model, None)
    prof = dataclasses.replace(get_profile("Web1"), prompt_mean=24, decode_mean=8)
    gen = RequestGenerator(prof, vocab_size=eng.cfg.vocab_size, seed=0)
    for _ in range(4):
        eng.submit(next(gen))
    eng.step()
    rec = FlightRecorder()
    rec.now_fn = eng.now
    eng.recorder = rec
    rec.register(eng.metrics)
    for _ in range(N_REQUESTS - 4):
        eng.submit(next(gen))
    _drive(eng)
    path = tmp_path / "trace.json"
    rec.write(str(path))
    events = read_trace(str(path) + ".device.json")
    summary = validate_trace_events(events)
    assert summary["spans"] == len(eng.timeline())
    steps = [e for e in events if e.get("name") == "step" and e["ph"] == "B"]
    assert len(steps) == eng.engine_steps - 1 and {e["tid"] for e in steps} == {0}
    assert abs(steps[0]["ts"] * 1e-6 - time.time()) < 600
    queues = {e["tid"] for e in events if e.get("name") == "queue"}
    assert queues == {rid + 1 for rid in range(4, N_REQUESTS)}  # the requests submitted after it
    assert json.loads(path.read_text())["traceEvents"]


# ---------------------------------------------------------------------------
# on the card


def _card_engine(recorder, **over):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the engine's graphs and kernels have no CPU mode")
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(), d_model=192, n_heads=3, n_kv_heads=1)
    api = get_model(cfg)
    eng = _engine(api, api.init(0, device="cuda"), recorder, device="cuda", prefetch_promote=False,
                  placement_window=64, **over)
    _submit(eng, 4)
    eng.step()  # admits all four (a host read each), and decodes
    return eng


@pytest.mark.cuda
def test_decode_step_with_the_timeline_adds_no_sync():
    eng = _card_engine(FlightRecorder())
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            eng.step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    eng.drain_tier_counters()  # a wait: reads the steps' points
    spans = eng.timeline()
    assert sum(s.name == "step" for s in spans) == 4
    assert all(s.dur >= 0 for s in spans)


@pytest.mark.cuda
def test_profiled_step_projects_no_serve_range_onto_the_device():
    eng = _card_engine(FlightRecorder())
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            eng.step()
        torch.cuda.synchronize()
    names = [(e.name, e.device_type) for e in prof.events()]
    assert any(n.startswith("serve.") for n, d in names if d != torch.autograd.DeviceType.CUDA)
    assert not [n for n, d in names if d == torch.autograd.DeviceType.CUDA and n.startswith("serve.")]
