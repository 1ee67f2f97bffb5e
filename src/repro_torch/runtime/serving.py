"""Serving engine: batching over paged, tiered, prefix-shared KV (mirrors repro/runtime/serving.py).

This slice ports the whole-slot path (``prefill_chunk == 0``): a request's
prompt prefills whole at admission through ``api.prefill``, and every step
decodes one token for each active slot. It serves every ported family
(``models/api.py``: dense, ssm = rwkv6, hybrid = zamba2) with one code
path: a slot write copies every cache leaf, and the tier store's payload
rows are a family's k and v vectors where it has a 5-D KV cache ``k``
(the dense layers', zamba2's shared-block applications') and synthetic
``counter_rows`` where it has none (rwkv6's O(1) state), as in the
reference. The paper's three findings run together here as in the
reference:

  * shared KV page table (core/pagetable): requests with common prompt
    prefixes map the same physical pages;
  * tiered placement (core/placement): hot pages stay in the near tier,
    cold pages demote to the far tier, driven by windowed access counts;
  * software prefetch (core/prefetch): the decode walk is predicted and its
    accuracy/coverage accounted (promotion is not ported yet).

Device tiering (``EngineConfig.device_tiering``): every step's KV page reads
run against the device-resident tiered store (runtime/tiered_kv) — ALL
active slots' page ids in ONE segmented tiered-gather kernel launch, with
per-segment near/far hit counts accumulated in the store's device counter
plane and drained once per profiler window (``drain_tier_counters``). With
identity scales the device-tiered engine is bit-identical to the
host-accounted one (same tokens, same counters).

PyTorch runs eagerly, so the reference's ``jax.jit`` decode with donated
cache buffers (serving.py:361-431) has no counterpart: the step runs the
model's decode directly and the KV cache is updated in place. The next
tokens stay on the device between steps; the host reads them only at an
admit's first-token argmax.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): chunked prefill (``prefill_chunk > 0``, A4.2), prefetch promotion
(``prefetch_promote``, A4.3), degraded mode with fenced placement,
``abort_all`` and ``lost_window`` (A4.4).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.memtrace import MemTracer
from repro_torch.core.pagetable import SharedKVPageTable
from repro_torch.core.placement import TieredPlacement
from repro_torch.core.prefetch import PrefetchEngine
from repro_torch.core.profiler import AccessProfiler
from repro_torch.data.requests import Request, RequestGenerator
from repro_torch.device import resolve_device, to_device, to_host
from repro_torch.env import env_flag
from repro_torch.models.api import ModelAPI, make_serve_step
from repro_torch.obs import Counter, MetricsRegistry, default_recorder
from repro_torch.runtime.tiered_kv import (
    N_ROLES,
    ROLE_DECODE,
    ROLE_PREFILL,
    TieredKVCache,
    sanitize_near_ids,
)


def _env_device_tiering() -> bool:
    return env_flag("REPRO_DEVICE_TIERING", default=False)


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer — the counter-based hash behind the synthetic
    payload rows (vectorized; uint64 wraparound is the intended ring)."""
    x = x.copy()
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


def counter_rows(seed: int, page_ids, versions, dim: int) -> np.ndarray:
    """Deterministic standard-normal payload rows keyed on (seed, page,
    write-version), generated by ONE vectorized counter-based draw.

    Replaces a per-page ``np.random.default_rng`` construction loop that
    dominated recurrent-family writes: every output element's uniform bits
    come from splitmix64 over (key, counter), then Box-Muller maps uniform
    pairs to normals — no sequential generator state anywhere.
    """
    pids = np.asarray(page_ids, np.uint64).reshape(-1)
    vers = np.asarray(versions, np.uint64).reshape(-1)
    key = _mix64(
        (np.uint64(seed) << np.uint64(40)) ^ (pids << np.uint64(20)) ^ vers
    )
    ctr = np.arange(2 * dim, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    h = _mix64(key[:, None] ^ ctr[None, :])
    u = (h >> np.uint64(11)).astype(np.float64) * (2.0 ** -53)
    u1 = np.maximum(u[:, :dim], 2.0 ** -53)  # log(0) guard
    u2 = u[:, dim:]
    rows = np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)
    return rows.astype(np.float32)


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 4
    max_len: int = 256
    page_size: int = 16
    n_pages: int = 1024
    near_frac: float = 0.30
    predictor: str = "nextline"
    prefetch_buffer: int = 64
    placement_window: int = 16  # engine steps per TPP epoch
    trace_window: int = 8
    trace_period: int = 64
    # device-executed tiering: route KV page reads through the tiered-gather
    # kernel over a device-resident near/far store
    device_tiering: bool = dataclasses.field(default_factory=_env_device_tiering)
    # one segmented dispatch per step (the default) vs one dispatch per
    # slot, kept as the dispatch-budget baseline
    segmented_lookup: bool = True
    # snap payload rows to the int8 grid so the far tier is lossless
    tiered_identity_scales: bool = False
    # differential probe: compare every tiered read against the flat
    # buffer in-line (tracks the max divergence in stats())
    tiered_verify: bool = False
    # trace-driven far-tier prefetch promotion (ROADMAP A4.3)
    prefetch_promote: bool = False
    prefetch_lookahead: int = 4
    prefetch_max_promote: int = 32
    # tensor-sharding degree of one logical replica (ROADMAP A7)
    model_shards: int = 1
    # prefill-chunk token budget per engine step; 0 = the whole-slot path
    # (chunked prefill is ROADMAP A4.2)
    prefill_chunk: int = 0


@dataclasses.dataclass
class _Slot:
    seq_id: int = -1
    remaining: int = 0
    request: Optional[Request] = None
    # when this request entered the slot (virtual time + engine step), so
    # retirement can emit one decode span labeled with its step range
    t_admit: float = 0.0
    start_step: int = 0

    @property
    def active(self) -> bool:
        return self.seq_id >= 0


class ServingEngine:
    def __init__(
        self,
        api: ModelAPI,
        params,
        ecfg: EngineConfig,
        seed: int = 0,
        recorder=None,
        device=None,
    ):
        if ecfg.prefill_chunk > 0:
            raise NotImplementedError("chunked prefill (prefill_chunk > 0) is ROADMAP A4.2")
        if ecfg.prefetch_promote:
            raise NotImplementedError("prefetch promotion (prefetch_promote) is ROADMAP A4.3")
        if ecfg.model_shards != 1:
            raise NotImplementedError("the sharded engine (model_shards > 1) is ROADMAP A7")
        self.device = resolve_device(device)
        self.api = api
        self.cfg = api.cfg
        self.ecfg = ecfg
        self.params = params
        p_dev = next(params.parameters()).device
        if p_dev != torch.empty(0, device=self.device).device:
            raise ValueError(f"params lie on {p_dev}, the engine runs on {self.device}")
        e = ecfg
        self.pagetable = SharedKVPageTable(e.n_pages, e.page_size)
        self.placement = TieredPlacement(
            e.n_pages,
            near_capacity=max(1, int(e.near_frac * e.n_pages)),
            block_bytes=self._page_bytes(),
        )
        # pages start in the far tier until placement promotes them
        self.placement.tier[:] = 1
        self.placement.tier[: self.placement.near_capacity] = 0
        self.prefetch = PrefetchEngine(e.predictor, e.prefetch_buffer)
        self.profiler = AccessProfiler(e.n_pages, self._page_bytes(), window_len=e.placement_window)
        self.tracer = MemTracer(e.trace_window, e.trace_period)
        self.slots = [_Slot() for _ in range(e.max_batch)]
        self.cache = api.init_cache(e.max_batch, e.max_len, device=self.device)
        self.queue: Deque[Request] = deque()
        self.finished: List[int] = []
        self.engine_steps = 0
        # unified metrics plane: the legacy totals are registry counters
        self.metrics = MetricsRegistry()
        self._m_tokens = self.metrics.counter("tokens_decoded")
        self._m_finished = self.metrics.counter("requests_finished")
        self._m_prefill = self.metrics.counter("prefill_tokens")
        self._m_prefill_saved = self.metrics.counter("prefill_tokens_saved")
        self._m_pf_promoted = self.metrics.counter("prefetch_promoted_pages")
        # delta-tracking for books owned elsewhere, synced at drain boundaries
        self._book_seen: Dict[str, int] = {}
        self.recorder = recorder if recorder is not None else default_recorder()
        if self.recorder is not None:
            self.recorder.register(self.metrics)
        # set by a fleet: replica id for span tracks, and the shared virtual
        # clock (None -> engine steps stand in for time)
        self.host_rid = -1
        self.now_fn: Optional[Callable[[], float]] = None
        # per-tenant books: registry Counters labeled tenant=<name>
        self.tenant_stats: Dict[str, Dict[str, Counter]] = {}
        # tenant name -> dense index into the device counter plane
        self._tenant_index: Dict[str, int] = {}
        # seq id (rid) -> tenant name for every request ever admitted
        self._seq_tenant: Dict[int, str] = {}
        # device-resident decode feedback: the step's argmax lands here and
        # feeds the next step without a host round-trip
        self.next_tokens = torch.zeros((e.max_batch,), dtype=torch.int32, device=self.device)
        # called with (page_ids, is_write) for every accounted block access
        self.access_hooks: List[Callable] = []
        # when True, an external planner owns placement (apply_placement)
        self.external_placement = False
        # host-visible far fraction of this step's KV page reads
        self.last_step_far_frac = 0.0
        # model-dispatch books: every model pass launched, and the prefill
        # passes among them (one per admit on the whole-slot path)
        self.model_dispatches = 0
        self.prefill_dispatches = 0
        # time-to-first-token, stamped at submit()
        self._enq_vt: Dict[int, float] = {}
        self._enq_wall: Dict[int, float] = {}
        self.ttft_vt_samples: List[float] = []
        self.ttft_wall_samples: List[float] = []
        # per-role (decode, prefill) x (near, far) tier hits from the drain
        self.role_hits = np.zeros((N_ROLES, 2), np.int64)
        # the decode kernel walks the cache in the pages the tier plane accounts
        self._serve = make_serve_step(api, vocab=self.cfg.vocab_size, page_size=e.page_size)
        self._seed = seed
        # device-executed tiering: a device-resident near/far store whose
        # tier map mirrors placement.tier
        self.tiered: Optional[TieredKVCache] = None
        self.tiered_max_err = 0.0  # max tiered-vs-flat read divergence seen
        self._page_wver = None  # per-page write version (fallback payloads)
        if e.device_tiering:
            self.tiered = self._make_tiered_store()
            self._page_wver = np.zeros(e.n_pages, np.int64)
            # initial fill: position the starting near set without charging
            # it to the migration books (nothing has been written yet)
            self.tiered.migrate(self.placement.near_blocks(), account=False)

    def _make_tiered_store(self):
        e = self.ecfg
        return TieredKVCache(
            e.n_pages,
            self._payload_dim(),
            self.placement.near_capacity,
            identity_scales=e.tiered_identity_scales,
            counter_slots=e.max_batch,
            device=self.device,
        )

    # ------------------------------------------------------------------
    @property
    def tokens_decoded(self) -> int:
        return self._m_tokens.value

    @property
    def prefill_tokens(self) -> int:
        return self._m_prefill.value

    @property
    def prefill_tokens_saved(self) -> int:
        return self._m_prefill_saved.value

    def now(self) -> float:
        """Virtual time if a fleet clock is attached, else engine steps."""
        return float(self.now_fn()) if self.now_fn is not None else float(self.engine_steps)

    # ------------------------------------------------------------------
    def _page_bytes(self) -> int:
        """Bytes of one logical KV page across all layers (k+v, bf16)."""
        c = self.cfg
        n_layers = getattr(c, "n_layers", 1)
        return self.ecfg.page_size * 2 * c.n_kv_heads * c.head_dim * 2 * n_layers

    # ------------------------------------------------------------------
    # device-tier payload plumbing

    def _dense_kv(self, cache) -> Optional[torch.Tensor]:
        """The (L, B, H, S, D) k-cache when this family exposes one."""
        k = cache.get("k") if isinstance(cache, dict) else None
        return k if k is not None and k.ndim == 5 else None

    def _payload_dim(self) -> int:
        k = self._dense_kv(self.cache)
        if k is not None:
            n_layers, _, n_heads, _, head_dim = k.shape
            return 2 * n_layers * n_heads * head_dim
        return 128  # recurrent-state families: synthetic payload rows

    def _payload_rows(self, cache, batch_idxs, positions, page_ids) -> torch.Tensor:
        """Per-page payload rows for the device tier store: the k and v
        vectors of each page's most recently written token, flattened across
        layers and heads (one batched gather for all (slot, position) pairs).
        """
        k = self._dense_kv(cache)
        if k is not None:
            bi = to_device(batch_idxs, torch.int64, self.device)
            pos = to_device(positions, torch.int64, self.device)
            # advanced indices (batch, seq-pos) are separated by a slice, so
            # PyTorch (like NumPy and JAX) moves their broadcast dim to the
            # front: (n, L, H, Dh) per store
            kk = k[:, bi, :, pos, :]
            vv = cache["v"][:, bi, :, pos, :]
            kv = torch.cat([kk, vv], dim=1)  # (n, 2L, H, Dh)
            return kv.reshape(len(positions), -1).float()
        pids = np.asarray(page_ids, np.int64)
        return to_device(
            counter_rows(self._seed, pids, self._page_wver[pids], self.tiered.row_dim),
            torch.float32, self.device,
        )

    def _tiered_write(self, cache, batch_idxs, positions, page_ids):
        if self.tiered is None or not len(page_ids):
            return
        rows = self._payload_rows(cache, batch_idxs, positions, page_ids)
        self.tiered.write(np.asarray(page_ids, np.int64), rows)
        self._page_wver[np.asarray(page_ids, np.int64)] += 1

    def _sync_device_tiers(self):
        """Mirror placement.tier into the device store (real data movement)."""
        if self.tiered is not None:
            self.tiered.migrate(self.placement.near_blocks())

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        # stamp arrival so TTFT covers queue wait, not just slot residency
        self._enq_vt[req.rid] = self.now()
        self._enq_wall[req.rid] = time.perf_counter()
        self.queue.append(req)

    def _record_ttft(self, req: Request):
        """First generated token exists for ``req`` — close its TTFT."""
        t = self.now()
        vt = t - self._enq_vt.pop(req.rid, t)
        self.ttft_vt_samples.append(vt)
        self.metrics.histogram("ttft", tenant=req.tenant).record(vt)
        wall = self._enq_wall.pop(req.rid, None)
        if wall is not None:
            self.ttft_wall_samples.append(time.perf_counter() - wall)

    def _admit(self):
        """Fill freed slots from the queue at the top of every step. The
        prompt prefills whole through ``api.prefill`` (one model dispatch
        per admit, charged to ``prefill_dispatches``), and its first token
        is the one host read of the step's argmax."""
        for slot_idx, slot in enumerate(self.slots):
            if slot.active or not self.queue:
                continue
            req = self.queue.popleft()
            budget = max(1, self.ecfg.max_len - 2)
            tokens = req.tokens[:budget]
            decode_len = max(1, min(req.decode_len, self.ecfg.max_len - len(tokens) - 1))
            share = self.pagetable.add_sequence(req.rid, tokens)
            self._m_prefill.inc(len(tokens))
            self._m_prefill_saved.inc(share["shared"] * self.ecfg.page_size)
            slot.seq_id = req.rid
            slot.remaining = decode_len
            slot.request = req
            slot.t_admit = self.now()
            slot.start_step = self.engine_steps
            self._tenant(req.tenant)  # register the tenant counter index
            self._seq_tenant[req.rid] = req.tenant
            # the prefetch buffer is partitioned per tenant
            self.prefetch.set_stream_partition(req.rid, req.tenant)
            batch = {"tokens": to_device(np.asarray(tokens)[None, :], torch.int32, self.device)}
            logits1, cache1 = self.api.prefill(self.params, batch, max_len=self.ecfg.max_len)
            self.model_dispatches += 1
            self.prefill_dispatches += 1
            self._write_slot(slot_idx, cache1)
            if self.tiered is not None:
                # seed the device tier store with this sequence's page
                # payloads (each page keyed by its last prefilled token)
                pages = self.pagetable.seqs[req.rid]
                ps = self.ecfg.page_size
                positions = [
                    min((i + 1) * ps, len(tokens)) - 1 for i in range(len(pages))
                ]
                self._tiered_write(self.cache, [slot_idx] * len(pages), positions, pages)
            nxt = int(to_host(torch.argmax(logits1[0, -1, : self.cfg.vocab_size])))
            self.next_tokens[slot_idx] = nxt
            self._record_ttft(req)
            if self.recorder is not None:
                self.recorder.span(
                    "prefill",
                    req.rid,
                    slot.t_admit,
                    slot.t_admit,
                    tenant=req.tenant,
                    replica=self.host_rid,
                    prompt_tokens=len(tokens),
                    shared_pages=share["shared"],
                )

    def _write_slot(self, slot_idx: int, cache1: dict):
        """Copy a batch-1 prefill cache into slot ``slot_idx`` of the batched
        cache, in place. 1-D leaves (lengths) carry batch on axis 0,
        everything else on axis 1."""
        for key, dst in self.cache.items():
            src = cache1[key]
            if dst.ndim == 1:
                dst[slot_idx] = src[0]
            else:
                dst[:, slot_idx] = src[:, 0]

    # ------------------------------------------------------------------
    def _tenant(self, name: str) -> Dict[str, Counter]:
        if name not in self.tenant_stats:
            self.tenant_stats[name] = {
                "tokens_decoded": self.metrics.counter("tenant_tokens_decoded", tenant=name),
                "requests_finished": self.metrics.counter("tenant_requests_finished", tenant=name),
                "near_hits": self.metrics.counter("tenant_near_hits", tenant=name),
                "far_hits": self.metrics.counter("tenant_far_hits", tenant=name),
            }
        self._tenant_index.setdefault(name, len(self._tenant_index))
        return self.tenant_stats[name]

    def _sync_registry_books(self):
        """Mirror externally-owned books (placement stats, prefetch books, the
        device store's host books) into the registry by delta, at drain
        boundaries only. Pure int sums: totals are identical at any cadence."""

        def charge(name: str, current: int):
            seen = self._book_seen.get(name, 0)
            if current != seen:
                self.metrics.counter(name).inc(current - seen)
                self._book_seen[name] = current

        st = self.placement.stats
        charge("near_hits", st.near_hits)
        charge("far_hits", st.far_hits)
        charge("promotions", st.promotions)
        charge("demotions", st.demotions)
        charge("migrated_bytes", st.migrated_bytes)
        pf = self.prefetch.stats
        charge("prefetch_issued_pages", pf.total_prefetched)
        charge("prefetch_used_pages", pf.used_prefetches)
        charge("prefetch_unused_evicted_pages", pf.unused_evicted)
        charge("prefetch_demand_fetches", pf.demand_fetches)
        charge(
            "prefetch_wasted_bytes", pf.unused_evicted * self.placement.block_bytes
        )
        if self.tiered is not None:
            tk = self.tiered
            charge("kv_moved_rows", tk.moved_rows)
            charge("kv_moved_bytes", tk.moved_bytes)
            charge("kv_writes", tk.writes)
            charge("kv_dispatches", tk.dispatches)
            charge("kv_host_syncs", tk.host_syncs)
            charge("kv_drains", tk.drains)

    def drain_tier_counters(self) -> Optional[dict]:
        """Drain the device counter plane and charge the host books: the ONE
        host read of the tiered decode path, once per profiler window (and at
        stats/placement boundaries). The books are bit-identical whatever the
        drain cadence, because the plane is a pure sum."""
        d = None
        if self.tiered is not None:
            d = self.tiered.drain_counters()
            if d["near"] or d["far"]:
                self.placement.stats.near_hits += d["near"]
                self.placement.stats.far_hits += d["far"]
                self.role_hits += np.asarray(d["role"], np.int64)
                tenant_rows = d["tenant"]
                for name, idx in self._tenant_index.items():
                    if idx < len(tenant_rows):
                        n, f = int(tenant_rows[idx][0]), int(tenant_rows[idx][1])
                        if n or f:
                            ts = self._tenant(name)
                            ts["near_hits"].inc(n)
                            ts["far_hits"].inc(f)
        self._sync_registry_books()
        return d

    def _verify(self, rows, ids):
        """tiered_verify: fold the tiered-vs-flat divergence of one read in."""
        err = float(to_host((rows - self.tiered.lookup_flat(ids)).abs().max()))
        self.tiered_max_err = max(self.tiered_max_err, err)

    def _account_decode(self):
        """Per decode step: every active sequence touches all its KV pages —
        that stream drives placement, prefetch, the profiler and the tracer.

        With device tiering the read is EXECUTED: all active slots' page ids
        go through ONE segmented tiered-gather launch, and the per-slot
        near/far hit counts accumulate into the store's device counter plane
        (no host read here)."""
        segs = []
        for slot_idx, slot in enumerate(self.slots):
            if not slot.active:
                continue
            pages = np.array(self.pagetable.seqs[slot.seq_id], np.int64)
            if pages.size:
                segs.append((slot_idx, slot, pages))
        if not segs:
            return
        segmented = self.tiered is not None and self.ecfg.segmented_lookup
        if segmented:
            ids = np.concatenate([p for _, _, p in segs])
            seg_of = np.repeat(
                np.arange(len(segs), dtype=np.int32), [p.size for _, _, p in segs]
            )
            rows = self.tiered.lookup_segments(
                ids,
                seg_of,
                self.ecfg.max_batch + 1,  # last segment absorbs the padding
                slot_idx=[i for i, _, _ in segs],
                tenant_idx=[self._tenant_index[s.request.tenant] for _, s, _ in segs],
                role_idx=[ROLE_DECODE] * len(segs),
            )
            if self.ecfg.tiered_verify:
                self._verify(rows, ids)
        far_total = n_total = 0
        for slot_idx, slot, pages in segs:
            far = self.placement.tier[pages] == 1
            far_total += int(far.sum())
            n_total += pages.size
            if not segmented:
                if self.tiered is not None:
                    rows, near_n, far_n = self.tiered.lookup(pages)
                    self.placement.stats.near_hits += near_n
                    self.placement.stats.far_hits += far_n
                    if self.ecfg.tiered_verify:
                        self._verify(rows, pages)
                else:
                    self.placement.access(pages)
                    near_n = int((~far).sum())
                    far_n = int(far.sum())
                ts = self._tenant(slot.request.tenant)
                ts["near_hits"].inc(near_n)
                ts["far_hits"].inc(far_n)
            # stream = the sequence id: each request's page walk is its own
            self.prefetch.access_many(pages, far, stream=slot.seq_id)
            self.profiler.record("kv", pages)
            self.tracer.record(pages, is_write=False, stream=slot.seq_id)
            self.profiler.record(f"kv.{slot.request.tenant}", pages)
            for hook in self.access_hooks:
                hook(pages, False)
        self.last_step_far_frac = far_total / n_total if n_total else 0.0

    def step(self) -> int:
        """One engine iteration: admit -> decode -> account -> retire.

        One model dispatch (the batched decode with its argmax) and one
        tiered-gather launch; no host read except an admit's first token
        and the profiler-window drain. Returns tokens decoded this step.
        """
        self._admit()
        if not any(s.active for s in self.slots):
            return 0
        nxt, self.cache = self._serve(self.params, self.cache, self.next_tokens[:, None])
        self.next_tokens = nxt[:, 0]
        self.model_dispatches += 1
        self._account_decode()
        decoded = 0
        written: List[int] = []
        written_tenant: List[str] = []
        written_slot: List[int] = []
        written_pos: List[int] = []
        written_seq: List[int] = []
        for slot_idx, slot in enumerate(self.slots):
            if not slot.active:
                continue
            written.append(self.pagetable.append_token(slot.seq_id))
            written_tenant.append(slot.request.tenant)
            written_slot.append(slot_idx)
            written_pos.append(self.pagetable.seq_len[slot.seq_id] - 1)
            written_seq.append(slot.seq_id)
            slot.remaining -= 1
            decoded += 1
            ts = self._tenant(slot.request.tenant)
            ts["tokens_decoded"].inc()
            if slot.remaining <= 0:
                self.pagetable.free_sequence(slot.seq_id)
                self.finished.append(slot.seq_id)
                self.prefetch.drop_stream(slot.seq_id)
                ts["requests_finished"].inc()
                if self.recorder is not None:
                    t1 = self.now()
                    self.recorder.span(
                        "decode",
                        slot.seq_id,
                        slot.t_admit,
                        t1,
                        tenant=slot.request.tenant,
                        replica=self.host_rid,
                        step_range=[slot.start_step, self.engine_steps],
                    )
                    self.recorder.instant(
                        "complete",
                        slot.seq_id,
                        t1,
                        tenant=slot.request.tenant,
                        replica=self.host_rid,
                    )
                self._m_finished.inc()
                slot.seq_id = -1
                slot.request = None
        if written:
            # the decoded token's KV write, executed on the device store too
            w = np.asarray(written, np.int64)
            if self.tiered is not None:
                self._tiered_write(self.cache, written_slot, written_pos, written)
            self.profiler.record("kv", w, rw="w")
            by_tenant: Dict[str, List[int]] = {}
            for page, tenant in zip(written, written_tenant):
                by_tenant.setdefault(tenant, []).append(page)
            for tenant, pages in by_tenant.items():
                self.profiler.record(f"kv.{tenant}", np.asarray(pages, np.int64), rw="w")
            self.tracer.record(w, is_write=True, stream=np.asarray(written_seq, np.int64))
            for hook in self.access_hooks:
                hook(w, True)
        self._m_tokens.inc(decoded)
        self.engine_steps += 1
        self.profiler.tick()
        self.tracer.tick()
        # profiler-window boundary: drain the device counter plane into the
        # host books, then run the TPP epoch (unless a planner owns placement)
        if self.engine_steps % self.ecfg.placement_window == 0:
            self.drain_tier_counters()
            if not self.external_placement:
                wins = self.profiler.windows("kv")
                if wins:
                    self.placement.step(wins[-1])
                    self._sync_device_tiers()
        return decoded

    def run(self, gen: RequestGenerator, n_requests: int, max_steps: int = 10_000) -> dict:
        for _ in range(n_requests):
            self.submit(next(gen))
        steps = 0
        while (self.queue or any(s.active for s in self.slots)) and steps < max_steps:
            self.step()
            steps += 1
        return self.stats()

    # ------------------------------------------------------------------
    def apply_placement(self, near_ids: np.ndarray, epoch: Optional[int] = None) -> int:
        """Push an externally-planned near-tier set. Replaces the local TPP
        view wholesale; returns the number of pages whose tier changed.
        Epoch-fenced pushes belong to the failure machinery (ROADMAP A4.4)."""
        if epoch is not None:
            raise NotImplementedError("epoch-fenced apply_placement is ROADMAP A4.4")
        # drain first: hits observed under the outgoing tier map are charged
        # before the map changes, so every epoch's books are exact
        self.drain_tier_counters()
        return self._apply_near_set(near_ids)

    def _apply_near_set(self, near_ids: np.ndarray) -> int:
        """Unconditional tier rewrite under the shared sanitize rule."""
        near_ids = sanitize_near_ids(
            near_ids, self.ecfg.n_pages, self.placement.near_capacity
        )
        old = self.placement.tier.copy()
        self.placement.tier[:] = 1
        self.placement.tier[near_ids] = 0
        promoted = int((old[near_ids] == 1).sum())
        demoted = int(((old == 0) & (self.placement.tier == 1)).sum())
        st = self.placement.stats
        st.promotions += promoted
        st.demotions += demoted
        st.migrated_bytes += (promoted + demoted) * self.placement.block_bytes
        # device mode: the push is real data movement
        self._sync_device_tiers()
        self._sync_registry_books()
        if self.recorder is not None and (promoted or demoted):
            t = self.now()
            self.recorder.span(
                "migrate",
                -1,
                t,
                t,
                replica=self.host_rid,
                promoted=promoted,
                demoted=demoted,
                bytes=(promoted + demoted) * self.placement.block_bytes,
            )
        return promoted + demoted

    # ------------------------------------------------------------------
    # failure machinery: a later slice (ROADMAP A4.4)

    def enter_degraded(self, fence_epoch: Optional[int] = None) -> int:
        raise NotImplementedError("degraded far-tier-only mode is ROADMAP A4.4")

    def exit_degraded(self, fence_epoch: Optional[int] = None):
        raise NotImplementedError("degraded far-tier-only mode is ROADMAP A4.4")

    def abort_all(self):
        raise NotImplementedError("abort_all is ROADMAP A4.4")

    def lost_window(self) -> dict:
        raise NotImplementedError("lost_window is ROADMAP A4.4")

    # ------------------------------------------------------------------
    def live_counters(self) -> dict:
        """Ground-truth counters a fleet aggregator validates against."""
        self.drain_tier_counters()
        kv = self.profiler._stream("kv")
        return {
            "reads": kv.reads,
            "writes": kv.writes,
            "rw_ratio": self.profiler.rw_ratio("kv"),
            "near_hit_rate": self.placement.stats.hit_rate,
            "accesses": int(kv.counts.sum()),
        }

    def stats(self) -> dict:
        # finalized view: pages sitting unused in the prefetch buffer at
        # report time are wasted bandwidth the LRU never got to charge
        ps = self.prefetch.finalized_stats()
        device = None
        self.drain_tier_counters()
        steps = max(self.engine_steps, 1)
        if self.tiered is not None:
            device = {
                **self.tiered.stats(),
                "max_read_error": self.tiered_max_err,
                # 1 dispatch and (1/placement_window) syncs per step
                "dispatches_per_step": self.tiered.dispatches / steps,
                "host_syncs_per_step": self.tiered.host_syncs / steps,
                "decode_near_hits": int(self.role_hits[ROLE_DECODE, 0]),
                "decode_far_hits": int(self.role_hits[ROLE_DECODE, 1]),
                "prefill_near_hits": int(self.role_hits[ROLE_PREFILL, 0]),
                "prefill_far_hits": int(self.role_hits[ROLE_PREFILL, 1]),
            }
        tv = self.ttft_vt_samples
        return {
            "device_tiering": device,
            "serving": {
                "model_dispatches": self.model_dispatches,
                "prefill_dispatches": self.prefill_dispatches,
                "model_dispatches_per_step": self.model_dispatches / steps,
                "ttft_p50": float(np.percentile(tv, 50)) if tv else 0.0,
                "ttft_p99": float(np.percentile(tv, 99)) if tv else 0.0,
                "ttft_count": len(tv),
            },
            "tokens_decoded": self.tokens_decoded,
            "requests_finished": len(self.finished),
            "prefill_tokens": self.prefill_tokens,
            "prefill_tokens_saved": self.prefill_tokens_saved,
            "near_hit_rate": self.placement.stats.hit_rate,
            "migrations": self.placement.stats.promotions + self.placement.stats.demotions,
            "prefetch_accuracy": ps.accuracy,
            "prefetch_coverage": ps.coverage,
            "prefetch_bw_overhead": ps.bw_overhead,
            "prefetch_promoted_pages": self._m_pf_promoted.value,
            "pagetable": self.pagetable.stats(),
            "tenants": {
                t: {
                    **{k: c.value for k, c in ts.items()},
                    "near_hit_rate": ts["near_hits"].value
                    / max(ts["near_hits"].value + ts["far_hits"].value, 1),
                }
                for t, ts in self.tenant_stats.items()
            },
        }
