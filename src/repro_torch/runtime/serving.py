"""Serving engine: continuous batching over paged, tiered, prefix-shared KV
(mirrors repro/runtime/serving.py).

It serves every family (``models/api.py``: dense, moe, ssm = rwkv6, hybrid
= zamba2, vlm = qwen2-vl, audio = whisper) with one code path: a slot
write copies every cache leaf (whisper's cross caches too), and the tier
store's payload rows are a family's k and v vectors where it has a 5-D KV
cache ``k`` (the dense, moe and vlm layers', zamba2's shared-block
applications', whisper's decoder self-attention) and synthetic ``counter_rows`` where it has none (rwkv6's
O(1) state), as in the reference. The paper's three findings run together
here as in the reference:

  * shared KV page table (core/pagetable): requests with common prompt
    prefixes map the same physical pages;
  * tiered placement (core/placement): hot pages stay in the near tier,
    cold pages demote to the far tier, driven by windowed access counts;
  * software prefetch (core/prefetch): the decode walk is predicted, its
    accuracy/coverage accounted, and with ``prefetch_promote`` the predicted
    far pages are promoted into the near tier at each placement-window
    boundary (``_prefetch_window``) ahead of the steps that will read them.

Device tiering (``EngineConfig.device_tiering``): every step's KV page reads
run against the device-resident tiered store (runtime/tiered_kv) — ALL
active slots' page ids in ONE segmented tiered-gather kernel launch, with
per-segment near/far hit counts accumulated in the store's device counter
plane and drained once per profiler window (``drain_tier_counters``). With
identity scales the device-tiered engine is bit-identical to the
host-accounted one (same tokens, same counters).

Two paths, as in the reference. Whole-slot (``prefill_chunk == 0``): a
request's prompt prefills whole at admission through ``api.prefill`` (one
more model dispatch, and the one host read of the step, its first token's
argmax), and every step decodes one token for each slot. Continuous
batching with chunked prefill (``prefill_chunk > 0``): admission only maps
pages, zeroes the slot's cache rows in place and arms a ``ChunkState``;
while any slot is mid-prompt, a step runs the chunk columns of
``_chunk_plan``, each one decode of the whole batch in which a prompt row
takes its next prompt token, a decode row its fed-back token, and a row
inactive in the column keeps every cache leaf bit for bit (the decode's
``active`` gate). The prompt's KV page reads ride the step's one segmented
lookup as ROLE_PREFILL segments, its completed pages go through the tiered
write path, and TTFT closes the step its last prompt token lands. A step
with no slot mid-prompt is a plain decode, as on the whole-slot path.
Either way a step is one model dispatch and one tiered dispatch.

Each dispatch writes its results into the engine's own buffers in place:
the cache and the next tokens (which feed the next step on the device; the
host never reads them on the serving path), and for the chunk columns the
plan, staged through pinned memory, and a column counter. So the same
function serves both devices. On the CPU it runs eagerly. On a CUDA device
the engine captures it at construction as a CUDA graph (``runtime/graphs``:
the counterpart of the reference's jitted decode and chunk step) and every
step replays it: the decode once, the chunk step once a column, as far as
the last column any row is active in (the columns after it are no-ops
under the gate). Only a mesh engine runs eagerly on the card (by its
class, ``_captures``), and a failed capture
raises. The tier plane (lookups, writes, drains, migrations, whose id
counts change every step) stays outside the graphs. The kernel wrappers'
``LAUNCHES`` count a capture once; the engine counts its replays
(``graph_launches``). An engine's weights stay fixed for its lifetime: its
graphs read them, and their held casts, where they were at capture.

The fleet drives an engine through the same interface as the reference's:
``load``, ``step_cost`` and ``backlog_tokens`` for routing and admission,
epoch-fenced ``apply_placement`` for the fleet's tier plans, and the failure
machinery: degraded far-tier-only serving (``enter_degraded`` /
``exit_degraded``), ``stranded_requests``, ``abort_all`` and ``lost_window``.
An aborted slot is refilled in place by the next admission, as any freed
slot is (``_write_slot`` on the whole-slot path, ``_reset_slot`` on the
chunked one); the graphs' buffers never move.

With ``model_shards > 1`` the engine is a ``runtime.sharded.ShardedServingEngine``,
whose tiered store is split into that many page-interleaved shards on the
engine's device (``ServingEngine(...)`` constructs one); ``model_shards``
must divide ``n_pages``. Given a mesh of cards, a ``ShardedServingEngine``
spans them: the seams it uses here are the cache (``_new_cache``: each
rank's share of the KV heads), the payload rows (``_payload_dim``,
``_payload_rows``: whole rows, gathered across the ranks), the argmax
over logits gathered whole (``launch.mesh.whole``) and the choice of
dispatch (``_captures``: a mesh engine runs its dispatches eagerly).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.memtrace import MemTracer
from repro_torch.core.pagetable import SharedKVPageTable
from repro_torch.core.placement import TieredPlacement
from repro_torch.core.prefetch import PrefetchEngine, train_tenant_successors
from repro_torch.core.profiler import AccessProfiler
from repro_torch.data.requests import ChunkState, Request, RequestGenerator
from repro_torch.device import resolve_device, stage_into, to_device, to_host
from repro_torch.env import env_flag
from repro_torch.launch import mesh as meshlib
from repro_torch.models.api import ModelAPI, make_serve_step
from repro_torch.obs import Counter, MetricsRegistry, default_recorder
from repro_torch.obs.timeline import OFF, DeviceSpan, DeviceTimeline
from repro_torch.kernels import launch_counts
from repro_torch.runtime.graphs import StepGraph
from repro_torch.runtime.tiered_kv import (
    N_ROLES,
    ROLE_DECODE,
    ROLE_PREFILL,
    TieredKVCache,
    sanitize_near_ids,
)

# families whose decode_step can consume prompt tokens incrementally (the
# chunked-prefill substrate). Excluded: "audio" (whisper's cross-attention
# caches exist only after an encode+prefill pass) and "vlm" (prompt embeds
# carry M-RoPE positions the decode path does not reconstruct) — both fall
# back to monolithic prefill at admit regardless of the chunk budget.
CHUNKABLE_FAMILIES = ("dense", "moe", "ssm", "hybrid")


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


def _write_back(dst: dict, new: dict):
    """Copy every leaf of a decode's returned cache that is a new tensor (the
    advanced lengths) into the engine's cache leaf, in place; the others
    are the engine's own tensors, written by the decode itself."""
    for key, t in dst.items():
        if new[key] is not t:
            t.copy_(new[key])


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
    # trace-driven far-tier prefetch: at every placement-window boundary,
    # chase each active stream's predictor chain and promote predicted far
    # pages into the near tier ahead of the steps that will read them
    prefetch_promote: bool = False
    # how many predicted transitions ahead of each stream's head to chase
    prefetch_lookahead: int = 4
    # cap on promoted pages per issue window (bounds wasted bandwidth)
    prefetch_max_promote: int = 32
    # page-interleaved shards of one logical replica's tiered store
    # (runtime/sharded; the parameters stay whole on the one card)
    model_shards: int = 1
    # continuous batching: prefill-chunk token budget per engine step. 0 =
    # the whole-slot path (the whole prompt prefills at admit through
    # api.prefill); positive values feed every prompt in chunks of at most
    # this many tokens, interleaved with decode in the step's one dispatch
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
    # chunked prefill: non-None while the slot is still feeding its prompt
    # (cleared the step its final prompt token lands and its first
    # generated token is emitted)
    chunk: Optional[ChunkState] = None
    chunks_done: int = 0  # prefill chunks this occupancy has dispatched
    shared_pages: int = 0  # prefix pages shared at admit (span labeling)
    decode_assigned: int = 0  # decode budget granted at admit

    @property
    def active(self) -> bool:
        return self.seq_id >= 0

    @property
    def prefilling(self) -> bool:
        return self.active and self.chunk is not None


class ServingEngine:
    def __new__(cls, api: ModelAPI, params, ecfg: EngineConfig, *args, **kwargs):
        # model_shards > 1 is one logical replica over a sharded store
        if cls is ServingEngine and ecfg.model_shards > 1:
            from repro_torch.runtime.sharded import ShardedServingEngine

            cls = ShardedServingEngine
        return super().__new__(cls)

    def __init__(
        self,
        api: ModelAPI,
        params,
        ecfg: EngineConfig,
        seed: int = 0,
        recorder=None,
        device=None,
    ):
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
        # the dispatches' buffers, written in place and never rebound (the
        # card's graphs hold their addresses): the cache, and the
        # device-resident decode feedback, where the step's argmax lands and
        # feeds the next step without a host round-trip
        self._bufs = {
            "cache": self._new_cache(),
            "next": torch.zeros((e.max_batch,), dtype=torch.int32, device=self.device),
        }
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
        # the device timeline (obs/timeline.py): on while a recorder is
        # attached (the ``recorder`` setter), OFF otherwise
        self._timeline: Optional[DeviceTimeline] = None
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
        # called with (page_ids, is_write) for every accounted block access
        self.access_hooks: List[Callable] = []
        # when True, an external planner owns placement (apply_placement)
        self.external_placement = False
        # degraded far-tier-only mode (enter_degraded): placement planning,
        # prefetch promotion and external pushes are suspended; lookups keep
        # flowing through the same single segmented dispatch, all far hits
        self.degraded = False
        # epoch fence for apply_placement: plans stamped at or below it
        # predate a failover/degrade transition and are rejected as stale
        self._placement_fence = 0
        # engine step of the last counter-plane drain (sizes lost_window)
        self._last_drain_step = 0
        # virtual-time cost of one step for the fleet's event scheduler;
        # None -> 1.0 (must stay 1.0 for lockstep-exact replays)
        self.step_cost_fn: Optional[Callable[["ServingEngine"], float]] = None
        # host-visible far fraction of this step's KV page reads
        self.last_step_far_frac = 0.0
        # model-dispatch books: every model pass launched, and the prefill
        # passes among them (one per admit on the whole-slot path)
        self.model_dispatches = 0
        self.prefill_dispatches = 0
        # time-to-first-token, stamped at submit()
        self._enq_vt: Dict[int, float] = {}
        self.ttft_vt_samples: List[float] = []
        # per-role (decode, prefill) x (near, far) tier hits from the drain
        self.role_hits = np.zeros((N_ROLES, 2), np.int64)
        # per-slot (start, end) prompt intervals of the chunk step in flight,
        # set by step() before the dispatch and consumed by _account_decode
        # and the post-step bookkeeping
        self._step_chunks: Dict[int, Tuple[int, int]] = {}
        # slot -> the timeline point after the chunk column that emitted its
        # first token (the end of its prefill span)
        self._emit_at: Dict[int, object] = {}
        # chunked prefill is gated per family (see CHUNKABLE_FAMILIES)
        self.chunking = e.prefill_chunk > 0 and api.family in CHUNKABLE_FAMILIES
        # whole-batch decodes run: one a decode step, one a chunk column (so
        # each runs every layer's decode kernel once), and the columns alone
        self.batch_decodes = 0
        self.chunk_columns = 0
        # the decode kernel walks the cache in the pages the tier plane accounts
        self._serve = make_serve_step(api, vocab=self.cfg.vocab_size, page_size=e.page_size)
        self._seed = seed
        if self.chunking:
            # the chunk step's column plan (token, use-prompt, active, emit),
            # staged each step, and the column its next column reads
            self._bufs["plan"] = torch.zeros((4, e.max_batch, e.prefill_chunk), dtype=torch.int32,
                                             device=self.device)
            self._bufs["col"] = torch.zeros((1,), dtype=torch.int64, device=self.device)
        # on the card every dispatch is a captured graph, replayed
        self._graphs: Dict[str, StepGraph] = {}
        if self._captures():
            with torch.cuda.device(self.device):
                g = self._graphs["decode"] = StepGraph(self._decode_fn, self._bufs)
                if self.chunking:
                    self._graphs["column"] = StepGraph(self._column_fn, self._bufs, pool=g.pool())
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

    def _new_cache(self) -> dict:
        return self.api.init_cache(self.ecfg.max_batch, self.ecfg.max_len, device=self.device)

    def _captures(self) -> bool:
        """Whether the dispatches are captured as CUDA graphs: on the card."""
        return self.device.type == "cuda"

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
    def recorder(self):
        """The attached flight recorder (or None). The engine calls only its
        ``register``, ``span`` and ``instant``; attaching one turns the
        device timeline on and hands it over through ``register``."""
        return self._recorder

    @recorder.setter
    def recorder(self, rec):
        self._recorder = rec
        self._tl = OFF
        if rec is not None:
            if self._timeline is None:
                self._timeline = DeviceTimeline(self.device)
            rec.register(self._timeline)
            self._tl = self._timeline

    def timeline(self, t0: float = float("-inf"), t1: float = float("inf")) -> List[DeviceSpan]:
        """The device timeline's finished spans that end between host times
        ``t0`` and ``t1`` (``time.perf_counter`` seconds), by start: what the
        device has completed, read without waiting. Empty if no recorder
        was ever attached."""
        return [] if self._timeline is None else self._timeline.read(t0, t1)

    @property
    def cache(self) -> dict:
        """The batched cache, updated in place (never rebound)."""
        return self._bufs["cache"]

    @property
    def next_tokens(self) -> torch.Tensor:
        """(max_batch,) int32 on the device: each slot's next fed token."""
        return self._bufs["next"]

    def graph_launches(self) -> Dict[str, int]:
        """Kernel launches made by this engine's graph replays (each graph's
        captured launches times its replays), per kernel; all 0 on the CPU.
        The wrappers' ``LAUNCHES`` count only the eager launches (and a
        capture once), so a path's launches are theirs plus these."""
        out = dict.fromkeys(launch_counts(), 0)
        for g in self._graphs.values():
            for k, n in g.replayed().items():
                out[k] += n
        return out

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
        """A payload row's width: every KV head (a rank over a mesh holds its
        share of them) over the cache's own first axis (zamba2's
        shared-block applications, not its layers)."""
        k = self._dense_kv(self.cache)
        if k is not None:
            return 2 * k.shape[0] * self.cfg.n_kv_heads * k.shape[4]
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
            kv = self._whole_heads(torch.cat([kk, vv], dim=1))  # (n, 2L, H, Dh)
            return kv.reshape(len(positions), -1).float()
        pids = np.asarray(page_ids, np.int64)
        return to_device(
            counter_rows(self._seed, pids, self._page_wver[pids], self.tiered.row_dim),
            torch.float32, self.device,
        )

    def _whole_heads(self, kv: torch.Tensor) -> torch.Tensor:
        """(n, 2L, H, Dh) payload vectors with every KV head: the cache holds
        them all on one device."""
        return kv

    def _tiered_write(self, cache, batch_idxs, positions, page_ids):
        if self.tiered is None or not len(page_ids):
            return
        rows = self._payload_rows(cache, batch_idxs, positions, page_ids)
        self.tiered.write(np.asarray(page_ids, np.int64), rows)
        self._page_wver[np.asarray(page_ids, np.int64)] += 1

    def _sync_device_tiers(self):
        """Mirror placement.tier into the device store (real data movement)."""
        if self.tiered is not None:
            sp = self._tl.enter("migrate")
            moved = self.tiered.migrate(self.placement.near_blocks())
            self._tl.leave(sp, promoted=moved["promoted"], demoted=moved["demoted"],
                           bytes=moved["moved_bytes"])

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        # stamp arrival so TTFT covers queue wait, not just slot residency
        self._enq_vt[req.rid] = self.now()
        self._tl.open("queue", req.rid, at=time.perf_counter())
        self.queue.append(req)

    def _record_ttft(self, req: Request):
        """First generated token exists for ``req`` — close its TTFT."""
        t = self.now()
        vt = t - self._enq_vt.pop(req.rid, t)
        self.ttft_vt_samples.append(vt)
        self.metrics.histogram("ttft", tenant=req.tenant).record(vt)

    def _admit_common(self, slot: _Slot, req: Request):
        """Slot bookkeeping shared by both admission paths. Returns the
        (truncated) prompt and the pagetable share record."""
        budget = max(1, self.ecfg.max_len - 2)
        tokens = req.tokens[:budget]
        decode_len = max(1, min(req.decode_len, self.ecfg.max_len - len(tokens) - 1))
        share = self.pagetable.add_sequence(req.rid, tokens)
        self._m_prefill.inc(len(tokens))
        self._m_prefill_saved.inc(share["shared"] * self.ecfg.page_size)
        slot.seq_id = req.rid
        slot.remaining = decode_len
        slot.decode_assigned = decode_len
        slot.request = req
        slot.t_admit = self.now()
        slot.start_step = self.engine_steps
        slot.chunk = None
        slot.chunks_done = 0
        self._tenant(req.tenant)  # register the tenant counter index
        self._seq_tenant[req.rid] = req.tenant
        # the prefetch buffer is partitioned per tenant
        self.prefetch.set_stream_partition(req.rid, req.tenant)
        return tokens, share

    def _admit(self):
        """Fill freed slots from the queue at the top of every step.

        Whole-slot path: the prompt prefills whole through ``api.prefill``
        (one model dispatch per admit, charged to ``prefill_dispatches``),
        and its first token is the one host read of the step's argmax.
        Chunked path: admission maps pages, zeroes the slot's cache rows in
        place and arms a ChunkState; the prompt flows through the chunk
        columns of the following steps, with no host read.

        On the device timeline: ``admit``, its host bookkeeping
        (``admit.host``), and each request's ``queue`` closed and
        ``prefill`` opened where its prefill starts on the device; a
        whole-slot ``prefill`` holds ``prefill.model`` and ends when its
        first token is back on the host (and is reported to the recorder
        after that, outside any host-only span)."""
        tl = self._tl
        with tl.phase("admit"):
            for slot_idx, slot in enumerate(self.slots):
                if slot.active or not self.queue:
                    continue
                with tl.phase("admit.host", host_only=True):
                    req = self.queue.popleft()
                    tokens, share = self._admit_common(slot, req)
                at = tl.mark()
                tl.close("queue", req.rid, at)
                if self.chunking:
                    tl.open("prefill", req.rid, at)
                    self._reset_slot(slot_idx)
                    slot.chunk = ChunkState(tokens=tokens)
                    slot.shared_pages = share["shared"]
                    continue
                pre = tl.enter("prefill", req.rid, at=at)
                batch = self._prefill_batch(tokens)
                with tl.phase("prefill.model", req.rid):
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
                first = torch.argmax(meshlib.whole(logits1)[0, -1, : self.cfg.vocab_size])
                tl.settle()  # the host is about to wait for the prefill anyway
                nxt = int(to_host(first))
                tl.leave(pre, at=tl.waited())
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

    def _prefill_batch(self, tokens) -> dict:
        """A batch-1 prefill input in the family's keys, as the reference
        builds it: vlm's embeds are the (uncast) embedding rows with the
        three M-RoPE channels all at the text positions; audio's frames are
        the front end's stub, zeros."""
        t = to_device(np.asarray(tokens)[None, :], torch.int32, self.device)
        fam = self.api.family
        if fam == "vlm":
            n = t.shape[1]
            pos = torch.arange(n, dtype=torch.int32, device=self.device).expand(3, 1, n)
            # the rows of the table as stored (over a mesh its columns are
            # split: the rows are looked up on each rank's shard)
            return {"embeds": meshlib.take_rows(self.params.embed, t), "mrope_positions": pos}
        if fam == "audio":
            frames = torch.zeros((1, self.cfg.n_audio_frames, self.cfg.d_model), dtype=torch.bfloat16,
                                 device=self.device)
            return {"tokens": t, "frames": frames}
        return {"tokens": t}

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

    def _reset_slot(self, slot_idx: int):
        """Zero slot ``slot_idx`` of every cache leaf in place (the same axis
        rule as ``_write_slot``): chunked admission starts prefill from an
        empty slot, lengths 0 and recurrent state cleared, without
        allocating a cache."""
        for leaf in self.cache.values():
            leaf.select(0 if leaf.ndim == 1 else 1, slot_idx).zero_()

    def _chunk_plan(self):
        """Column plan for one continuous-batching step: (B, C) token ids
        plus the use-prompt / active / emit masks of the chunk columns, and
        the per-slot ``(start, end)`` prompt intervals this dispatch
        advances. Decode slots occupy column 0 only; each prefilling slot
        takes up to ``prefill_chunk`` prompt tokens and emits (captures its
        first generated token) only in the column that consumes its final
        prompt token."""
        e = self.ecfg
        C = e.prefill_chunk
        B = e.max_batch
        tok = np.zeros((B, C), np.int32)
        use_prompt = np.zeros((B, C), bool)
        active = np.zeros((B, C), bool)
        emit = np.zeros((B, C), bool)
        spans: Dict[int, Tuple[int, int]] = {}
        for i, s in enumerate(self.slots):
            if not s.active:
                continue
            if s.prefilling:
                c = s.chunk.take(C)
                n = len(c)
                tok[i, :n] = c
                use_prompt[i, :n] = True
                active[i, :n] = True
                emit[i, n - 1] = s.chunk.pos + n >= s.chunk.total
                spans[i] = (s.chunk.pos, s.chunk.pos + n)
            else:
                active[i, 0] = True
                emit[i, 0] = True
        return tok, use_prompt, active, emit, spans

    # ------------------------------------------------------------------
    # the dispatches: functions of the buffers, run eagerly on the CPU and
    # captured once and replayed on the card (module docstring)

    def _decode_fn(self, b: dict):
        """One decode of every slot with its argmax, the reference's fused
        decode: results written into the buffers."""
        nxt, cache = self._serve(self.params, b["cache"], b["next"][:, None])
        _write_back(b["cache"], cache)
        b["next"].copy_(nxt[:, 0])

    def _column_fn(self, b: dict):
        """One chunk column, the body of the reference's chunk scan: prompt
        rows feed their prompt token and decode rows their fed-back one; a
        row inactive in the column keeps its cache (the decode's gate), and
        a row's next token is replaced only in its emit column. Reads the
        column ``b["col"]`` of the staged plan and advances it."""
        col = b["plan"].index_select(2, b["col"])[..., 0]  # (4, B)
        tok, use_prompt, active, emit = col[0], col[1] != 0, col[2] != 0, col[3] != 0
        fed = torch.where(use_prompt, tok, b["next"])
        nxt, cache = self._serve(self.params, b["cache"], fed[:, None], active)
        _write_back(b["cache"], cache)
        b["next"].copy_(torch.where(emit, nxt[:, 0], b["next"]))
        b["col"].add_(1)

    def _dispatch(self, name: str):
        """Run dispatch ``name``: its captured graph where the engine captured
        one (``_captures``), else the function itself."""
        if self._graphs:
            self._graphs[name].replay()
        else:
            getattr(self, f"_{name}_fn")(self._bufs)

    def _chunk_step(self):
        """Stage the column plan and run its columns, up to the last one in
        which any row is active: a column where none is changes nothing."""
        tok, use_prompt, act, emit, spans = self._chunk_plan()
        self._step_chunks = spans
        n_cols = int(np.flatnonzero(act.any(axis=0))[-1]) + 1
        stage_into(self._bufs["plan"], np.stack([tok, use_prompt, act, emit]))
        self._bufs["col"].zero_()
        tl = self._tl
        # column -> the slots whose first token it emits: a timeline point
        # after its replay ends their prefill spans
        firsts: Dict[int, List[int]] = {}
        if tl.on:
            for i, (start, end) in spans.items():
                if emit[i, end - start - 1]:
                    firsts.setdefault(end - start - 1, []).append(i)
        with tl.phase("columns"):
            for c in range(n_cols):
                self._dispatch("column")
                if c in firsts:
                    at = tl.mark()
                    self._emit_at.update(dict.fromkeys(firsts[c], at))
        self.chunk_columns += n_cols
        self.batch_decodes += n_cols

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
        self._last_drain_step = self.engine_steps
        if self.tiered is not None:
            with self._tl.phase("drain"):
                reads = self.tiered.plane_dirty  # a clean plane drains without a host read
                d = self.tiered.drain_counters()
                if reads:
                    self._tl.waited()
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
        self._tl.waited()
        self.tiered_max_err = max(self.tiered_max_err, err)

    def _account_decode(self):
        """Per decode step: every active sequence touches all its KV pages —
        that stream drives placement, prefetch, the profiler and the tracer.

        With device tiering the read is EXECUTED: all active slots' page ids
        go through ONE segmented tiered-gather launch, and the per-slot
        near/far hit counts accumulate into the store's device counter plane
        (no host read here).

        Under chunked prefill a prefilling slot's walk is truncated to the
        pages whose KV content exists after this step's chunk, and its
        segment carries ROLE_PREFILL into the counter plane's role
        accumulator: the mixed prefill/decode step stays ONE lookup.

        On the device timeline: the ``lookup`` around the store's call, and
        the host work on either side of it as ``books`` (host-only, unless
        the per-slot baseline's lookups run inside it)."""
        tl = self._tl
        segmented = self.tiered is not None and self.ecfg.segmented_lookup
        with tl.phase("books", host_only=True):
            segs = []
            for slot_idx, slot in enumerate(self.slots):
                if not slot.active:
                    continue
                pages_all = self.pagetable.seqs[slot.seq_id]
                role = ROLE_DECODE
                if slot.prefilling and slot_idx in self._step_chunks:
                    end = self._step_chunks[slot_idx][1]
                    pages = np.array(pages_all[: -(-end // self.ecfg.page_size)], np.int64)
                    role = ROLE_PREFILL
                else:
                    pages = np.array(pages_all, np.int64)
                if pages.size:
                    segs.append((slot_idx, slot, pages, role))
            if segs and segmented:
                ids = np.concatenate([p for _, _, p, _ in segs])
                seg_of = np.repeat(
                    np.arange(len(segs), dtype=np.int32), [p.size for _, _, p, _ in segs]
                )
        if not segs:
            return
        if segmented:
            with tl.phase("lookup"):
                rows = self.tiered.lookup_segments(
                    ids,
                    seg_of,
                    self.ecfg.max_batch + 1,  # last segment absorbs the padding
                    slot_idx=[i for i, _, _, _ in segs],
                    tenant_idx=[self._tenant_index[s.request.tenant] for _, s, _, _ in segs],
                    role_idx=[r for _, _, _, r in segs],
                )
            if self.ecfg.tiered_verify:
                self._verify(rows, ids)
        with tl.phase("books", host_only=segmented or self.tiered is None):
            self._account_pages(segs, segmented)

    def _account_pages(self, segs, segmented: bool):
        """The host books of one step's page reads (``_account_decode``):
        the per-slot baseline's hit split, prefetch, profiler, tracer and
        hooks."""
        far_total = n_total = 0
        for slot_idx, slot, pages, _role in segs:
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

    def _finish_chunk(self, slot_idx: int, slot: _Slot, writes: List[tuple]):
        """Post-dispatch bookkeeping for one prefilling slot: advance the
        chunk cursor, queue the prompt pages this chunk completed for the
        tiered write path on ``writes`` (each page keyed by its last
        prefilled token, as the whole-slot admit seeds them; the step
        writes them after its host bookkeeping, in this order), and, when
        the final prompt token just landed, close TTFT: the emit column
        captured the request's first generated token into next_tokens."""
        start, end = self._step_chunks[slot_idx]
        slot.chunk.pos = end
        slot.chunks_done += 1
        if self.tiered is not None:
            pages = self.pagetable.seqs[slot.seq_id]
            ps = self.ecfg.page_size
            total = slot.chunk.total
            w_pages: List[int] = []
            w_pos: List[int] = []
            for i, pid in enumerate(pages):
                endpos = min((i + 1) * ps, total)
                if start < endpos <= end:
                    w_pages.append(pid)
                    w_pos.append(endpos - 1)
            if w_pages:
                writes.append(([slot_idx] * len(w_pages), w_pos, w_pages))
        t = self.now()
        if self.recorder is not None:
            self.recorder.span(
                "prefill_chunk",
                slot.seq_id,
                t,
                t,
                tenant=slot.request.tenant,
                replica=self.host_rid,
                tokens=end - start,
                chunk=slot.chunks_done,
            )
        if slot.chunk.done:
            prompt_tokens = slot.chunk.total
            slot.chunk = None
            self._record_ttft(slot.request)
            self._tl.close("prefill", slot.seq_id, self._emit_at.pop(slot_idx, None))
            if self.recorder is not None:
                self.recorder.span(
                    "prefill",
                    slot.seq_id,
                    slot.t_admit,
                    t,
                    tenant=slot.request.tenant,
                    replica=self.host_rid,
                    prompt_tokens=prompt_tokens,
                    chunks=slot.chunks_done,
                    shared_pages=slot.shared_pages,
                )

    def step(self) -> int:
        """One engine iteration: admit -> decode -> account -> retire.

        Continuous batching: ``_admit`` runs at the top of every step, so
        freed slots refill at once. While any slot is mid-prefill the step
        runs the chunk columns (prefill chunks and decode tokens in one
        model dispatch); otherwise the plain batched decode with its argmax.
        Either way one model dispatch and one tiered-gather launch, and no
        host read but a whole-slot admit's first token and the
        profiler-window drain. Returns tokens decoded this step.

        On the device timeline the step is a ``step`` span over its phases:
        ``admit``, ``decode`` or ``columns``, ``books`` and ``lookup``,
        ``retire``, ``write``, ``books``, and at a placement-window boundary
        ``epoch``; its ``prefills`` arg counts the first tokens it emitted.
        """
        tl = self._tl
        firsts = len(self.ttft_vt_samples)
        sp = tl.enter("step")
        try:
            decoded = self._step()
        finally:
            tl.leave(sp, prefills=len(self.ttft_vt_samples) - firsts)
        return decoded

    def _step(self) -> int:
        tl = self._tl
        self._admit()
        if not any(s.active for s in self.slots):
            return 0
        if any(s.prefilling for s in self.slots):
            self._chunk_step()
        else:
            self._step_chunks = {}
            with tl.phase("decode"):
                self._dispatch("decode")
            self.batch_decodes += 1
        self.model_dispatches += 1
        self._account_decode()
        with tl.phase("retire", host_only=True):
            decoded, chunk_writes, w = self._retire()
        if self.tiered is not None and (chunk_writes or w["page"]):
            # the prompt pages the chunks completed, then the decoded
            # tokens' KV, executed on the device store
            with tl.phase("write"):
                for slots, pos, pages in chunk_writes:
                    self._tiered_write(self.cache, slots, pos, pages)
                self._tiered_write(self.cache, w["slot"], w["pos"], w["page"])
        with tl.phase("books", host_only=True):
            if w["page"]:
                pages = np.asarray(w["page"], np.int64)
                self.profiler.record("kv", pages, rw="w")
                by_tenant: Dict[str, List[int]] = {}
                for page, tenant in zip(w["page"], w["tenant"]):
                    by_tenant.setdefault(tenant, []).append(page)
                for tenant, pids in by_tenant.items():
                    self.profiler.record(f"kv.{tenant}", np.asarray(pids, np.int64), rw="w")
                self.tracer.record(pages, is_write=True, stream=np.asarray(w["seq"], np.int64))
                for hook in self.access_hooks:
                    hook(pages, True)
            self._m_tokens.inc(decoded)
            self.engine_steps += 1
            self.profiler.tick()
            self.tracer.tick()
        # profiler-window boundary: drain the device counter plane into the
        # host books, then run the TPP epoch (unless a planner owns placement)
        if self.engine_steps % self.ecfg.placement_window == 0:
            self._epoch()
        return decoded

    def _retire(self):
        """The host side of a step after its dispatch: each prefilling slot's
        chunk books (``_finish_chunk``), each decoding slot's token appended
        to its pages and its books, and the slots whose requests finished
        freed. Returns (tokens decoded, the chunks' tiered writes, the
        decoded tokens' pages with their slot, position, sequence and
        tenant)."""
        decoded = 0
        chunk_writes: List[tuple] = []
        w: Dict[str, list] = {"page": [], "tenant": [], "slot": [], "pos": [], "seq": []}
        for slot_idx, slot in enumerate(self.slots):
            if not slot.active:
                continue
            if slot.prefilling:
                self._finish_chunk(slot_idx, slot, chunk_writes)
                continue
            w["page"].append(self.pagetable.append_token(slot.seq_id))
            w["tenant"].append(slot.request.tenant)
            w["slot"].append(slot_idx)
            w["pos"].append(self.pagetable.seq_len[slot.seq_id] - 1)
            w["seq"].append(slot.seq_id)
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
        return decoded, chunk_writes, w

    def _epoch(self):
        """A placement-window boundary (``epoch`` on the device timeline):
        the counter plane's ``drain``, the TPP ``plan`` and its ``migrate``,
        and the ``prefetch`` issue window."""
        tl = self._tl
        tl.settle()  # before the drain's wait, outside the boundary's span
        with tl.phase("epoch"):
            self.drain_tier_counters()
            # degraded mode suspends placement planning and prefetch
            # promotion (there is no near capacity to plan into); the drain
            # above still runs, so degraded books keep the same cadence
            if not self.external_placement and not self.degraded:
                with tl.phase("plan", host_only=True):
                    wins = self.profiler.windows("kv")
                    if wins:
                        self.placement.step(wins[-1])
                if wins:
                    self._sync_device_tiers()
            # the prefetch issue window runs right after the boundary drain:
            # its migration sees a clean counter plane and reads nothing back
            if self.ecfg.prefetch_promote and not self.degraded:
                with tl.phase("prefetch"):
                    if self.prefetch.predictor == "trace":
                        # tenant-partitioned local training: trace streams
                        # are seq ids, and _seq_tenant maps them to their
                        # tenant
                        self.prefetch.load_successors(
                            train_tenant_successors(self.tracer.windows[-32:], self._seq_tenant),
                            merge=True,
                        )
                    self._prefetch_window()

    def _prefetch_window(self) -> int:
        """Chase each predicted page chain and promote the predicted FAR
        pages into the near tier ahead of the decode steps that will read
        them (the paper's trace-driven prefetcher, acting).

        Candidates come from two predictions the placement counters cannot
        make: (a) each active walk's chain links and tail successors, and
        (b) the chains of QUEUED requests, whose first full prefix page
        names their template through the pagetable's chunk hash, chased
        through the trained successor table before a count exists for it.

        Swaps are ranked by value, not by count: a page's value for the next
        window is the number of readers it will serve, the active slots
        mapping it (pagetable ref) plus the queued requests about to walk it.
        Ties never churn. Among zero-value victims, pages deepest in the
        allocator's LIFO free list go first.

        The swap goes through ``apply_placement``, so promotions are real
        far->near dequant copies charged to the migration books and the
        device-moved-bytes counters. Returns pages promoted.
        """
        e = self.ecfg
        preds: List[int] = []
        seen = set()
        upcoming: Dict[int, int] = {}  # page -> queued readers about to walk it
        part_of: Dict[int, str] = {}  # page -> tenant partition that predicted it

        def add(p: int, tenant: str):
            if p not in seen:
                seen.add(p)
                preds.append(p)
                part_of[p] = tenant

        for slot in self.slots:
            if not slot.active:
                continue
            tenant = slot.request.tenant
            pages = self.pagetable.seqs.get(slot.seq_id, [])
            if not pages:
                continue
            if slot.prefilling:
                # the remaining chunk steps will read the not-yet-prefilled
                # tail of the mapped chain: count those pages as upcoming
                # readers, so mid-prefill promotion is amortized over chunks
                for p in pages[slot.chunk.pos // e.page_size:]:
                    upcoming[p] = upcoming.get(p, 0) + 1
                    add(p, tenant)
            # the decode walk re-reads the whole chain next step: one
            # predicted hop from every mapped page, then ``lookahead`` hops
            # past the tail (the pages about to be allocated and written)
            for src in pages:
                for p in self.prefetch.predict_chain(int(src), stream=slot.seq_id, lookahead=1):
                    if 0 <= p < e.n_pages:
                        add(p, tenant)
            for p in self.prefetch.predict_chain(
                int(pages[-1]), stream=slot.seq_id, lookahead=e.prefetch_lookahead
            ):
                if 0 <= p < e.n_pages:
                    add(p, tenant)
        ps = e.page_size
        for req in list(self.queue)[: e.max_batch]:
            if len(req.tokens) < ps:
                continue
            pid = self.pagetable.chains.get(self.pagetable._chain(0, req.tokens[:ps]))
            if pid is None or self.pagetable.pages[pid].ref <= 0:
                continue
            # chase the whole template chain from the successor table, in
            # the queued request's own tenant partition
            chain = [int(pid)] + self.prefetch.predict_chain(
                int(pid),
                stream=-1,
                lookahead=max(e.prefetch_lookahead, e.max_len // e.page_size),
                partition=req.tenant,
            )
            for p in chain:
                if not 0 <= p < e.n_pages:
                    continue
                upcoming[p] = upcoming.get(p, 0) + 1
                add(p, req.tenant)
        if not preds:
            return 0

        def value(p: int) -> int:
            # readers the page serves next window: the active mappers plus
            # the queued walkers
            return self.pagetable.pages[p].ref + upcoming.get(p, 0)

        # stale successors may name pages the allocator has reclaimed
        cand = [p for p in preds if self.pagetable.pages[p].ref > 0]
        cand = [p for p in cand if self.placement.tier[p] == 1]
        if not cand:
            return 0
        cand.sort(key=value, reverse=True)
        near_ids = np.flatnonzero(self.placement.tier == 0)
        free_pos = {int(pid): i for i, pid in enumerate(self.pagetable.free)}
        victims = sorted((int(b) for b in near_ids), key=lambda b: (value(b), free_pos.get(b, -1)))
        promote: List[int] = []
        evict: List[int] = []
        for c, v in zip(cand, victims):
            if len(promote) >= e.prefetch_max_promote or value(c) <= value(v):
                break  # sorted both ways: no later pair can be profitable
            promote.append(c)
            evict.append(v)
        if not promote:
            return 0
        promote_a = np.asarray(promote, np.int64)
        evict_a = np.asarray(evict, np.int64)
        keep = np.setdiff1d(near_ids, evict_a, assume_unique=True)
        # demoted pages leave the buffer first (unused ones are waste), and
        # promotions enter it as prefetched-not-yet-used, each charged to
        # the tenant partition whose prediction named it
        self.prefetch.evict(evict_a)
        self.apply_placement(np.concatenate([keep, promote_a]))
        self.prefetch.mark_prefetched(promote_a, partitions=[part_of.get(p, "") for p in promote])
        self._m_pf_promoted.inc(len(promote))
        return len(promote)

    def run(self, gen: RequestGenerator, n_requests: int, max_steps: int = 10_000) -> dict:
        for _ in range(n_requests):
            self.submit(next(gen))
        steps = 0
        while (self.queue or any(s.active for s in self.slots)) and steps < max_steps:
            self.step()
            steps += 1
        return self.stats()

    # ------------------------------------------------------------------
    # fleet interface (fleet/replica.py wraps these)

    @property
    def load(self) -> int:
        """Backlog metric for routing: busy slots + queued requests."""
        return sum(1 for s in self.slots if s.active) + len(self.queue)

    def step_cost(self) -> float:
        """Virtual-time units one call to ``step`` costs (fleet scheduler):
        1.0, or what the ``step_cost_fn`` hook prices from live state."""
        if self.step_cost_fn is None:
            return 1.0
        cost = float(self.step_cost_fn(self))
        if cost <= 0.0:
            raise ValueError(f"step_cost_fn must return > 0, got {cost}")
        return cost

    def backlog_tokens(self, prefill_weight: float = 1.0) -> float:
        """Pending work in token-equivalents (admission's backlog estimate).

        ``prefill_weight`` discounts prompt tokens as the caller's SLO cost
        model does. Chunk-aware: a prefilling slot owes its REMAINING chunk
        tokens, weighted like queued prompt work, not its whole prompt."""
        q = sum(prefill_weight * len(r.tokens) + r.decode_len for r in self.queue)
        a = 0.0
        for s in self.slots:
            if not s.active:
                continue
            a += s.remaining
            if s.prefilling:
                a += prefill_weight * s.chunk.remaining
        return q + a

    def apply_placement(self, near_ids: np.ndarray, epoch: Optional[int] = None) -> int:
        """Push an externally-planned near-tier set (fleet autotier).
        Replaces the local TPP view wholesale; returns the number of pages
        whose tier changed.

        ``epoch`` is the planner's sequence number. A push at or below the
        placement fence was planned from profiles gathered before a
        failover/degrade transition on this host and is rejected (counted,
        recorded, zero pages moved); so is any push while degraded."""
        # drain first: hits observed under the outgoing tier map are charged
        # before the map changes, so every epoch's books are exact
        self.drain_tier_counters()
        if epoch is not None and int(epoch) <= self._placement_fence:
            self.metrics.counter("placement_rejected", reason="stale_epoch").inc()
            if self.recorder is not None:
                self.recorder.instant(
                    "placement_rejected", -1, self.now(), replica=self.host_rid,
                    reason="stale_epoch", epoch=int(epoch), fence=self._placement_fence,
                )
            return 0
        if self.degraded:
            self.metrics.counter("placement_rejected", reason="degraded").inc()
            if self.recorder is not None:
                self.recorder.instant(
                    "placement_rejected", -1, self.now(), replica=self.host_rid,
                    reason="degraded",
                )
            return 0
        return self._apply_near_set(near_ids)

    def _apply_near_set(self, near_ids: np.ndarray) -> int:
        """Unconditional tier rewrite under the shared sanitize rule (the
        body ``apply_placement`` guards; ``enter_degraded`` calls it with the
        empty set while the degraded flag is up)."""
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
    # failure machinery: degraded mode, epoch fencing, abort/strand books

    def fence_placement(self, epoch: int):
        """Raise the placement fence: plans stamped at or below ``epoch``
        predate this failover transition and will be rejected as stale."""
        self._placement_fence = max(self._placement_fence, int(epoch))

    def enter_degraded(self, fence_epoch: Optional[int] = None) -> int:
        """Drop to far-tier-only serving: the near tier is capacity-zeroed.

        One accounting boundary: drain the hits observed under the old map,
        then demote every near row through the real migration path (it
        quantizes each into the far tier). Placement planning, prefetch
        promotion and external pushes are suspended until ``exit_degraded``;
        a step is unchanged (the same single segmented lookup, every read a
        far hit). Returns pages whose tier changed. Idempotent."""
        if self.degraded:
            return 0
        self.drain_tier_counters()
        self.degraded = True
        if self.tiered is not None:
            self.tiered.set_degraded(True)
        if fence_epoch is not None:
            self.fence_placement(fence_epoch)
        changed = self._apply_near_set(np.empty(0, np.int64))
        self.metrics.counter("degraded_entries").inc()
        if self.recorder is not None:
            self.recorder.instant("degraded", -1, self.now(), replica=self.host_rid, demoted=changed)
        return changed

    def exit_degraded(self, fence_epoch: Optional[int] = None):
        """Restore near-tier capacity. The near set stays empty until the
        next placement epoch refills it. Idempotent."""
        if not self.degraded:
            return
        self.degraded = False
        if self.tiered is not None:
            self.tiered.set_degraded(False)
        if fence_epoch is not None:
            self.fence_placement(fence_epoch)
        if self.recorder is not None:
            self.recorder.instant("restored", -1, self.now(), replica=self.host_rid)

    def stranded_requests(self) -> List[Tuple[Request, int]]:
        """Every request this engine would strand if it vanished now: the
        queued ones and the slot residents, each with the decode tokens
        already produced for it. Read-only: a crashed host is inventoried,
        never mutated."""
        out: List[Tuple[Request, int]] = [(r, 0) for r in self.queue]
        for slot in self.slots:
            if slot.active:
                done = 0 if slot.chunk is not None else slot.decode_assigned - slot.remaining
                out.append((slot.request, max(0, done)))
        return out

    def abort_all(self) -> List[Tuple[Request, int]]:
        """Abort every queued and resident request (hung-host quarantine).

        Frees pagetable mappings, predictor streams and slots, so a later
        re-dispatch of the same rid re-prefills cleanly from its prompt; the
        next admission refills a freed slot in place. Returns (request,
        decode tokens discarded) pairs; tokens already decoded stay in the
        books."""
        out: List[Tuple[Request, int]] = []
        for req in self.queue:
            self._enq_vt.pop(req.rid, None)
            self._tl.forget(req.rid)
            out.append((req, 0))
        self.queue.clear()
        for slot in self.slots:
            if not slot.active:
                continue
            req = slot.request
            done = 0 if slot.chunk is not None else slot.decode_assigned - slot.remaining
            self.pagetable.free_sequence(slot.seq_id)
            self.prefetch.drop_stream(slot.seq_id)
            self._enq_vt.pop(slot.seq_id, None)
            self._tl.forget(slot.seq_id)
            slot.seq_id = -1
            slot.request = None
            slot.chunk = None
            slot.remaining = 0
            out.append((req, max(0, done)))
        self._emit_at.clear()
        if out:
            self.metrics.counter("requests_aborted").inc(len(out))
        return out

    def lost_window(self) -> dict:
        """The undrained remainder a crash leaves behind: the counter plane
        since the last drain, read through the quarantine drain
        (``discard=True``: returned, never folded into the books), and its
        size in steps."""
        out = {"steps_undrained": int(self.engine_steps - self._last_drain_step), "near": 0, "far": 0}
        if self.tiered is not None:
            d = self.tiered.drain_counters(discard=True)
            out["near"] = int(d["near"])
            out["far"] = int(d["far"])
        return out

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
