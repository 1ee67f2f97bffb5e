"""Drive the program's serving engine over a cell's traffic and keep its
timeline.

What a cell drives is ``repro_torch.runtime.serving.ServingEngine`` through
``submit`` and ``step``, on the whole-slot path with device tiering, as the
engine runs it (on the card its decode is a captured graph, its prefills
eager). The harness reads the engine only through its public surface: its
``slots``, its ``next_tokens`` buffer, the ``prefill`` span it reports to a
recorder when a request's first token exists, and its tier store's
``lookup_segments`` (counted, and a few of its answers kept for the check).

Each step ends with a device-timeline stamp (a CUDA event), and the step's
next tokens are copied on the device into a history buffer: the host reads
nothing inside the window that the engine does not read itself.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from bench.frozen import work
from bench.harness import spec, weights as wmod
from bench.harness.timeline import RequestTimes
from bench.harness.traffic import Item, Traffic

class Stamp:
    """A point on the device timeline: a CUDA event on the card, the host
    clock on the CPU (where every op has finished when it returns)."""

    def __init__(self, device: torch.device):
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event(enable_timing=True)
            self.event.record()
            self.host = None
        else:
            self.host = time.perf_counter()

    def seconds_after(self, anchor: "Stamp") -> float:
        if self.event is None:
            return self.host - anchor.host
        return anchor.event.elapsed_time(self.event) * 1e-3


@dataclasses.dataclass
class Req:
    item: Item
    rid: int
    send: Optional[float] = None  # host clock: due time (open loop) or submit time
    after: Optional["Req"] = None  # closed loop: the request whose end sent this one
    slot: int = -1
    k0: int = -1  # harness step of its admission (its first decode)
    first_stamp: Optional[Stamp] = None
    done_step: int = -1

    @property
    def prompt_len(self) -> int:
        return len(self.item.tokens)


class Recorder:
    """The engine's recorder: the harness listens for the ``prefill`` span,
    which the whole-slot engine reports right after it has read the
    request's first token back."""

    def __init__(self, run: "Run"):
        self.run = run

    def register(self, registry):
        pass

    def instant(self, name, trace, t=None, **kw):
        pass

    def span(self, name, trace, t0, t1, **kw):
        if name == "prefill":
            self.run.on_first_token(trace)


@dataclasses.dataclass
class Capture:
    """One tier-store answer kept for the check: a request's page rows as
    the store gathered them at harness step ``k``, and the logits the step's
    decode gave its slot."""

    rid: int
    k: int
    slot: int
    ids: np.ndarray
    rows: torch.Tensor
    logits: Optional[torch.Tensor] = None


def build_model(config: dict, seed: int, device: torch.device):
    """(api, params, leaves): the program's model on ``device`` holding the
    benchmark's weights (``weights.draw``), and those weights by name."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.api import get_model

    cfg = ModelConfig(**config["port"])
    api = get_model(cfg)
    meta = api.init(device="meta")
    leaves = wmod.draw(wmod.layout_of(meta), cfg.n_layers, seed, device)
    return api, wmod.load_into(meta, leaves), leaves


class Run:
    """One run of a cell: set-up, warm-up, the window, and what it leaves for
    the check and the metrics."""

    def __init__(self, cell: spec.Cell, seed: int, device: torch.device):
        from repro_torch.runtime.serving import EngineConfig, ServingEngine

        config, mix = cell.config, cell.traffic
        self.cell, self.config, self.mix, self.seed, self.device = cell, config, mix, int(seed), device
        self.work = spec.family_work(cell.family, cell.root)
        if device.type == "cuda":
            # every CUDA source of the program built (in parallel, at its
            # first run in a checkout) before anything is served: a kernel
            # first met in an open loop's timed warm-up would stall it
            from repro_torch.kernels import build

            build.build_all()
        self.api, self.params, self.leaves = build_model(config, self.seed, device)
        self.cfg = self.api.cfg
        e = mix["engine"]
        self.ecfg = EngineConfig(max_batch=e["max_batch"], max_len=e["max_len"], page_size=e["page_size"],
                                 n_pages=e["n_pages"], near_frac=e["near_frac"], device_tiering=True,
                                 prefill_chunk=0)
        self.traffic = Traffic(mix, self.cfg.vocab_size, self.seed)
        self.reqs: Dict[int, Req] = {}
        self.admitted: List[tuple] = []
        self.k = 0  # harness steps so far
        self.stamps: List[Stamp] = []
        self.rows: List[int] = []  # slots decoded each step
        self.hist = torch.zeros((4096, e["max_batch"]), dtype=torch.int32, device=device)
        self.firsts = torch.zeros((4096,), dtype=torch.int32, device=device)
        # each request's prefill: its logits at the prompt's last position
        self.first_rows = torch.zeros((512, self.cfg.vocab_size), dtype=torch.float32, device=device)
        self._last_row = None
        self.lengths = np.zeros(e["max_batch"], np.int64)  # the cache's lengths, mirrored
        self.books = {"near": 0, "far": 0}
        self.captures: List[Capture] = []
        self.capture_rng = np.random.default_rng([self.seed, 1])
        self.capture_steps: set = set()  # harness steps at which one request's rows are kept
        # trace-run instruments
        self.calls: Dict[str, List[tuple]] = {}  # kernel -> work of each launch in the traced steps
        self.in_trace = False
        self.spans_on = False  # CUDA events around lookups and prefills: the window's, in a traced run
        self.lookup_ms: List[float] = []
        self.prefill_ms: List[float] = []
        self._pending: List[tuple] = []  # (kind, start, end) CUDA events, read after the window
        # each decode's logits, copied where the decode makes them (inside the
        # captured graph on the card): read at the steps that keep rows
        self.decode_rows = torch.zeros((e["max_batch"], self.cfg.vocab_size), dtype=torch.float32, device=device)
        self._wrap_decode()
        self.eng = ServingEngine(self.api, self.params, self.ecfg, seed=self.seed % 2**31,
                                 recorder=Recorder(self), device=device)
        # a cold near tier: the near set on the highest page ids, which the
        # allocator hands out last, so the run starts with its pages far and
        # placement has to promote the hot ones
        cap = self.eng.placement.near_capacity
        self.eng.apply_placement(np.arange(self.ecfg.n_pages - cap, self.ecfg.n_pages))
        self._wrap_store()
        self._wrap_prefill()

    # -- instruments ------------------------------------------------------
    def _events(self):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        return s, e

    def _wrap_store(self):
        store = self.eng.tiered
        orig = store.lookup_segments
        run = self

        def lookup(page_ids, seg_of, n_segments, slot_idx=None, tenant_idx=None, role_idx=None):
            ids = np.asarray(page_ids, np.int64).reshape(-1)
            near = store.tier_host[ids] == 0
            run.books["near"] += int(near.sum())
            run.books["far"] += int(ids.size - near.sum())
            timed = run.spans_on and run.device.type == "cuda"
            if timed:
                s, e = run._events()
                s.record()
            rows = orig(page_ids, seg_of, n_segments, slot_idx=slot_idx, tenant_idx=tenant_idx,
                        role_idx=role_idx)
            if timed:
                e.record()
                run._pending.append(("lookup", s, e))
            if run.in_trace:
                n = work.lookup_bucket(ids.size)
                padded = np.concatenate([ids, np.zeros(n - ids.size, np.int64)])
                run.calls.setdefault("tiered_lookup", []).append(work.tiered_lookup(
                    n, store.row_dim, store.near.element_size(), int(n_segments), padded, store.tier_host.copy()))
            if run.k in run.capture_steps and slot_idx:
                run._capture(rows, ids, np.asarray(seg_of).reshape(-1), list(slot_idx))
            return rows

        store.lookup_segments = lookup

    def _capture(self, rows, ids, seg, slots):
        j = int(self.capture_rng.integers(len(slots)))
        sel = np.flatnonzero(seg == j)
        rid = self.eng.slots[slots[j]].seq_id
        if sel.size == 0 or rid not in self.reqs:
            return
        self.captures.append(Capture(rid, self.k, slots[j], ids[sel].copy(),
                                     rows[int(sel[0]): int(sel[-1]) + 1].clone()))

    def _wrap_decode(self):
        """Copy every decode's logits into ``decode_rows``; installed before
        the engine captures its decode graph, so that the graph copies them."""
        api, orig, run = self.api, self.api.decode, self
        vocab = self.cfg.vocab_size

        def decode(params, cache, tokens, *, page_size=16, active=None):
            logits, new = orig(params, cache, tokens, page_size=page_size, active=active)
            run.decode_rows.copy_(logits[:, -1, :vocab])
            return logits, new

        api.decode = decode

    def _wrap_prefill(self):
        """Keep each prefill's logits at the prompt's last position (the row
        its first token is chosen from), on the device, for the check;
        in a traced run, time the prefill between CUDA events."""
        api, orig, run = self.api, self.api.prefill, self
        vocab = self.cfg.vocab_size

        def prefill(params, batch, *, max_len):
            timed = run.spans_on and run.device.type == "cuda"
            if timed:
                s, e = run._events()
                s.record()
            logits, cache = orig(params, batch, max_len=max_len)
            if timed:
                e.record()
                run._pending.append(("prefill", s, e))
            run._last_row = logits[0, -1, :vocab].clone()  # not a view: the logits go
            return logits, cache

        api.prefill = prefill

    # -- the engine's side -------------------------------------------------
    def on_first_token(self, rid: int):
        """The engine has just read request ``rid``'s first token back."""
        req = self.reqs[rid]
        req.first_stamp = Stamp(self.device)
        req.slot = next(i for i, s in enumerate(self.eng.slots) if s.seq_id == rid)
        req.k0 = self.k
        if rid >= self.firsts.shape[0]:
            self.firsts = torch.cat([self.firsts, torch.zeros_like(self.firsts)])
        if rid >= self.first_rows.shape[0]:
            self.first_rows = torch.cat([self.first_rows, torch.zeros_like(self.first_rows)])
        self.firsts[rid].copy_(self.eng.next_tokens[req.slot])
        self.first_rows[rid].copy_(self._last_row)
        self.lengths[req.slot] = req.prompt_len
        self.admitted.append((req.slot, rid))
        if self.in_trace:
            self._prefill_calls(req.prompt_len)

    def submit(self, item: Item, send: float, after: Optional[Req] = None) -> Req:
        from repro_torch.data.requests import Request

        req = Req(item, item.index, send=send, after=after)
        self.reqs[req.rid] = req
        self.eng.submit(Request(req.rid, item.tokens, item.decode_len, item.prefix_id, 0.0))
        return req

    def step(self) -> List[Req]:
        """One engine step; returns the requests it finished."""
        before = [(i, s.seq_id) for i, s in enumerate(self.eng.slots) if s.active]
        self.admitted = []
        with torch.profiler.record_function("bench.engine_step"):
            self.eng.step()
        self.stamps.append(Stamp(self.device))
        for cap in reversed(self.captures):
            if cap.k != self.k:
                break
            cap.logits = self.decode_rows[cap.slot].clone()
        if self.k >= self.hist.shape[0]:
            self.hist = torch.cat([self.hist, torch.zeros_like(self.hist)])
        self.hist[self.k].copy_(self.eng.next_tokens)
        decoding = before + self.admitted
        self.rows.append(len(decoding))
        if self.in_trace and decoding:
            self._decode_calls()
        if decoding:
            self.lengths += 1  # a whole-slot decode advances every row of the cache
        done = []
        for slot, rid in decoding:
            req = self.reqs[rid]
            if self.k == req.k0 + req.item.decode_len - 1:
                req.done_step = self.k
                done.append(req)
                if self.eng.slots[slot].seq_id == rid:
                    raise RuntimeError(f"request {rid} should have ended at step {self.k}")
            elif self.eng.slots[slot].seq_id != rid:
                raise RuntimeError(f"request {rid} left slot {slot} early at step {self.k}")
        self.k += 1
        return done

    # -- work of each kernel launch in the traced steps (the family's) -----
    def _add_calls(self, calls: dict):
        for kernel, launches in calls.items():
            self.calls.setdefault(kernel, []).extend(launches)

    def _prefill_calls(self, t: int):
        self._add_calls(self.work.prefill_calls(self.config["port"], t))

    def _decode_calls(self):
        self._add_calls(self.work.decode_calls(self.config["port"], self.mix["engine"], list(self.lengths + 1)))

    # -- after the window ----------------------------------------------------
    def read_pending(self):
        for kind, s, e in self._pending:
            (self.lookup_ms if kind == "lookup" else self.prefill_ms).append(s.elapsed_time(e))
        self._pending = []

    def served_tokens(self, req: Req, hist: np.ndarray, firsts: np.ndarray, upto: Optional[int] = None):
        """The tokens the engine served ``req``: its first, then one a decode
        step (``upto`` decode steps; all of them by default)."""
        n = req.item.decode_len if upto is None else upto
        steps = np.arange(req.k0, req.k0 + n)
        return np.concatenate([[firsts[req.rid]], hist[steps, req.slot]]).astype(np.int64)

    def times(self, anchor: Stamp, anchor_host: float) -> List[RequestTimes]:
        """Every admitted request's send time and token times, on the host clock."""
        at = [anchor_host + s.seconds_after(anchor) for s in self.stamps]
        out = []
        for req in self.reqs.values():
            if req.k0 < 0:
                continue
            first = anchor_host + req.first_stamp.seconds_after(anchor)
            last = req.k0 + req.item.decode_len
            toks = [first] + at[req.k0: min(last, len(at))]
            send = req.send
            if req.after is not None and req.after.done_step >= 0:
                send = at[req.after.done_step]
            out.append(RequestTimes(send, toks))
        return out
