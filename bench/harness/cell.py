"""One run of a cell, start to end: set-up, warm-up, the measured window,
the traced stretch right after it (``--trace 1``), the metrics, and the
check."""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from bench.harness import check, spec, trace as tracemod
from bench.harness.driver import Run, Stamp
from bench.harness.timeline import end_to_end, in_window
from bench.reference.common import Precision


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads: the run, its window, its
    request times, and the traced stretch's summary (None without one)."""

    run: Run
    t_open: float
    t_close: float
    k_open: int  # the window's engine steps: k_open <= k < k_close
    k_close: int
    times: list
    summary: Optional[tracemod.TraceSummary]
    model_flops: float

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warm_allocator(run: Run):
    """One prefill at the mix's longest prompt, so the allocator holds blocks
    of every size the window's prefills ask for before the window opens."""
    t = run.traffic.longest_prompt()
    tokens = torch.zeros((1, t), dtype=torch.int32, device=run.device)
    run.api.prefill(run.params, {"tokens": tokens}, max_len=run.ecfg.max_len)
    _sync(run.device)


class Driver:
    """The serving loop: a closed loop of ``clients`` or an open loop at
    ``rate`` requests a second."""

    def __init__(self, run: Run):
        self.run = run
        loop = run.mix["loop"]
        self.closed = loop["kind"] == "closed"
        self.lateness: List[float] = []
        self.origin = None
        self.next_item = None
        self.due = None
        self.in_window = False

    def start(self):
        now = time.perf_counter()
        if self.closed:
            for _ in range(int(self.run.mix["loop"]["clients"])):
                self.run.submit(self.run.traffic.next(), send=now)
        else:
            self.origin = now
            self.next_item = self.run.traffic.next()
            self.due = self.origin + self.next_item.gap

    def _arrivals(self, now: float):
        while self.due <= now:
            self.run.submit(self.next_item, send=self.due)
            if self.in_window:
                self.lateness.append(now - self.due)
            self.next_item = self.run.traffic.next()
            self.due += self.next_item.gap

    def busy(self) -> bool:
        eng = self.run.eng
        return bool(eng.queue) or any(s.active for s in eng.slots)

    def turn(self, until: float):
        """Submit what is due, then one engine step (or, with nothing to
        serve, wait for the next arrival)."""
        if not self.closed:
            with torch.profiler.record_function("bench.arrivals"):
                self._arrivals(time.perf_counter())
            if not self.busy():
                with torch.profiler.record_function("bench.idle"):
                    time.sleep(max(0.0, min(self.due, until) - time.perf_counter()))
                return
        done = self.run.step()
        if self.closed:
            with torch.profiler.record_function("bench.clients"):
                now = time.perf_counter()
                for req in done:
                    self.run.submit(self.run.traffic.next(), send=now, after=req)

    def run_until(self, until: float, steps: Optional[int] = None):
        k0 = self.run.k
        while time.perf_counter() < until and (steps is None or self.run.k - k0 < steps):
            self.turn(until)


def execute(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: torch.device,
            process_age: Callable[[], float], limits: Optional[Dict[str, float]] = None,
            control: Optional[Precision] = None) -> dict:
    """One run; returns the result line's fields (and ``info``). With
    ``control``, the check also judges the reference at that precision in
    the program's place, against the same limits: its numbers, whether
    they are correct and each item's reading go into ``info["control"]``."""
    mix = cell.traffic
    run = Run(cell, seed, device)
    warm_allocator(run)
    drv = Driver(run)
    _sync(device)
    anchor, anchor_host = Stamp(device), time.perf_counter()
    drv.start()
    warm = mix["warmup"]
    t_warm = time.perf_counter()
    if drv.closed:
        drv.run_until(float("inf"), steps=int(warm["steps"]))
    else:
        drv.run_until(time.perf_counter() + float(warm["seconds"]))
    _sync(device)
    warm_s = time.perf_counter() - t_warm
    steps_per_s = run.k / max(warm_s, 1e-9)
    # the window
    setup_s = process_age()
    t_open = time.perf_counter()
    t_close = t_open + seconds
    drv.in_window = True
    run.spans_on = trace
    k_open = run.k
    # the check keeps one request's rows at each of a few steps, spread over
    # the first half of the window's expected steps
    n_cap = int(mix["check"]["row_captures"])
    every = max(1, int(steps_per_s * seconds / (2 * n_cap)))
    run.capture_steps = {k_open + every * (i + 1) for i in range(n_cap)}
    drv.run_until(t_close)
    k_close, queue_at_close = run.k, len(run.eng.queue)
    drv.in_window = False
    run.spans_on = False
    summary = None
    if trace:
        # right after the window, under the same load: the profiler's own
        # start and stop stay out of the measured window
        summary = _traced_stretch(run, drv, float("inf"), int(mix["trace"]["steps"]), device)
    _sync(device)
    run.read_pending()
    times = run.times(anchor, anchor_host)
    e2e = end_to_end(times, t_open, t_close)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    eng = run.eng
    eng.drain_tier_counters()
    books = {"near": eng.tiered.near_hits, "far": eng.tiered.far_hits}
    st = eng.stats()
    hist = run.hist[: run.k].cpu().numpy()
    firsts = run.firsts.cpu().numpy()
    window_flops = _window_flops(run, times, t_open, t_close)
    ctx = Context(run, t_open, t_close, k_open, k_close, times, summary, window_flops)
    per_layer = {}
    if trace:
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"], cell.root)(ctx)
            if value is not None:
                per_layer[m["name"]] = {"value": value, "unit": m["unit"]}
    sent = [r for r in run.reqs.values() if r.send is not None and in_window(r.send, t_open, t_close)]
    info = {
        "window_s": seconds, "steps": k_close - k_open, "warmup_steps": k_open,
        "sent": len(sent), "completed": sum(1 for r in run.reqs.values()
                                            if r.done_step >= k_open and r.done_step < k_close),
        "failed": 0, "ttft_p50_ms": e2e["ttft_p50_ms"], "ttft_samples": e2e["ttft_samples"],
        "itl_p50_ms": e2e["itl_p50_ms"], "itl_samples": e2e["itl_samples"],
        "queue_at_close": queue_at_close,
        "late_p50_ms": 1e3 * float(np.median(drv.lateness)) if drv.lateness else None,
        "late_max_ms": 1e3 * float(np.max(drv.lateness)) if drv.lateness else None,
        "near_hit_rate": st["near_hit_rate"], "near_hits": books["near"], "far_hits": books["far"],
        "dispatches_per_step": st["device_tiering"]["dispatches_per_step"],
        "host_syncs_per_step": st["device_tiering"]["host_syncs_per_step"],
        "prefill_tokens_saved": st["prefill_tokens_saved"], "prefill_tokens": st["prefill_tokens"],
        "memory_peak_bytes": memory_peak,
    }
    if trace:
        info["tier_lookup_ms_n"] = len(run.lookup_ms)
        info["prefill_ms_n"] = len(run.prefill_ms)
    # the program's state goes before the reference runs (its graphs hold
    # the engine in a reference cycle, which only the collector frees)
    run.eng = None
    del eng, st
    run.params = None
    run.api = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    limits = limits or spec.limits(cell.name, cell.root)
    result = check.judge(run, hist, firsts, books, limits, device)
    info["check_s"] = time.perf_counter() - t_check
    info["check_served_tokens"] = result["served"]
    info["check_requests"] = result["requests"]
    info["check_rows"] = result["rows_captured"]
    info["check_items"] = result["items"]
    if control is not None:
        t_control = time.perf_counter()
        low = check.judge(run, hist, firsts, books, limits, device, control)
        info["control"] = {"numbers": {k: n["value"] for k, n in low["numbers"].items()},
                           "correct": check.correct(low["numbers"]), "items": low["items"],
                           "seconds": time.perf_counter() - t_control}
    metrics = {
        "decode_tok_s": {"value": e2e["decode_tok_s"], "unit": "tokens/s"},
        "ttft_p95_ms": {"value": e2e["ttft_p95_ms"], "unit": "ms"},
        "itl_p95_ms": {"value": e2e["itl_p95_ms"], "unit": "ms"},
        "setup_s": {"value": setup_s, "unit": "s"},
    }
    out = {
        "correct": check.correct(result["numbers"]),
        "attempted": len(sent),
        "failed": 0,
        "metrics": per_layer if trace else {m["name"]: metrics[m["name"]] for m in cell.end_to_end},
        "device": {"memory_peak_bytes": memory_peak},
        "info": info,
        "check": result["numbers"],
    }
    if trace:
        out["device"]["busy_s"] = summary.busy_s
        out["device"]["window_s"] = summary.window_s
        out["breakdown"] = {"device_ops": [list(x) for x in summary.device_ops],
                            "idle_gaps": [list(x) for x in summary.idle_gaps]}
    return out


def _traced_stretch(run: Run, drv: Driver, until: float, steps: int, device) -> tracemod.TraceSummary:
    """``steps`` engine steps at the window's start under ``torch.profiler``,
    each end of the stretch after a synchronize."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    _sync(device)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    t0 = time.perf_counter()
    run.in_trace = True
    drv.run_until(until, steps=steps)
    _sync(device)
    t1 = time.perf_counter()
    run.in_trace = False
    prof.stop()
    return tracemod.summarize(prof, t1 - t0)


def _window_flops(run: Run, times, t_open: float, t_close: float) -> float:
    """Model FLOPs (the family's) of the window's prompts, whose first token
    landed in it, and of its decoded tokens, at the positions they were fed
    at."""
    cfg, per_token, total = run.config["port"], run.work.flops_per_token, 0.0
    reqs = [r for r in run.reqs.values() if r.k0 >= 0]
    for req, rt in zip(reqs, times):
        if in_window(rt.tokens[0], t_open, t_close):
            total += sum(per_token(cfg, p) for p in range(req.prompt_len))
        for i, t in enumerate(rt.tokens[1:]):
            if in_window(t, t_open, t_close):
                total += per_token(cfg, req.prompt_len + i)
    return total
