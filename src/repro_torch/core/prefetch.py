"""Software far-tier prefetch engine + the paper's accuracy/coverage accounting.

TPUs have no hardware prefetcher into HBM; the serving engine prefetches
far-tier blocks (KV pages, experts, embedding rows) ahead of the decode step
and overlaps the host->HBM copy with compute. The paper's §6 accounting maps
verbatim (CL -> block):

  Accuracy = 1 - unused_prefetched_evicted / total_prefetched
  Coverage = (total_prefetched - unused_evicted)
           / (total_blocks_brought_in - unused_evicted)

Predictors (selectable, mirroring the L2-prefetcher taxonomy plus the
paper's proposal):
  * nextline — block b -> b+1 (sequential KV walks: near-perfect)
  * stride   — per-stream stride detection
  * markov   — first-order successor table, trained online
  * trace    — successor table TRAINED FROM FLEET TRACES (MemProf §6's
    pitch: the production tracing tool exists to drive better prefetchers).
    ``train_successors`` learns per-stream block transitions from
    ``core.memtrace.TraceWindow``s — the same windows the fleet aggregator
    stitches and validates <=5% against live counters — and the table is
    shipped fleet-wide through ``fleet.autotier.TierEpoch``. The predictor
    issues ONLY trained successors (no heuristic fallback): sequential
    regions of the training traces teach b -> b+1 by themselves, so it
    covers everything the trace evidence supports at a fraction of the
    baselines' wasted bandwidth (fig21/fig22 score all of them).

Predictor state is keyed PER STREAM (decode slot / tenant / trace lane):
``_last``/``_stride`` live on a per-stream record and markov transitions
are only trained within a stream. An earlier revision interleaved every
caller into one global stream and learned transitions that never happen in
any single request stream — exactly the aggregate-stream mistraining
"Memory Controller Design Under Cloud Workloads" warns about.

The paper's headline finding — high accuracy but LOW coverage on irregular
streams, with real bandwidth overhead — reproduces here for the hardware
baselines: a markov table covers only repeated transitions, nextline fails
on scattered page chains, and every wrong prefetch costs a far-tier fetch
(benchmarks/fig21/fig22). The trace-trained table closes that coverage gap;
see ROADMAP "Recent" for the measured numbers.

End-of-run accounting: blocks still resident-but-unused in the prefetch
buffer at teardown are wasted bandwidth like any other unused prefetch.
``finalized_stats()`` (non-destructive) / ``finalize()`` (flushes the
buffer) charge them to ``unused_evicted`` so fig22 accuracy is not
overstated by whatever happened to be resident when the run ended.
"""
from __future__ import annotations

import collections
import dataclasses
import types
from typing import Dict, Hashable, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

# buffer/table partition for streams with no tenant attached (standalone
# engines, benchmarks, direct scoring runs): everything shares one slice,
# which is exactly the pre-partition behavior
DEFAULT_PARTITION = ""


@dataclasses.dataclass
class PrefetchStats:
    total_prefetched: int = 0
    unused_evicted: int = 0
    used_prefetches: int = 0
    demand_fetches: int = 0  # far-tier fetches NOT covered by a prefetch

    @property
    def accuracy(self) -> float:
        if self.total_prefetched == 0:
            return 1.0
        return 1.0 - self.unused_evicted / self.total_prefetched

    @property
    def coverage(self) -> float:
        brought_in = self.total_prefetched + self.demand_fetches
        denom = brought_in - self.unused_evicted
        if denom <= 0:
            return 0.0
        return (self.total_prefetched - self.unused_evicted) / denom

    @property
    def bw_overhead(self) -> float:
        """Extra blocks moved vs. a perfect (demand-only) fetcher."""
        useful = self.used_prefetches + self.demand_fetches
        return (self.total_prefetched + self.demand_fetches) / max(useful, 1) - 1.0

    def finalized(self, resident_unused: int) -> "PrefetchStats":
        """End-of-run view: prefetches still pending at teardown count as
        unused evictions — the bandwidth was spent and no miss was ever
        covered, the run just ended before the LRU charged them."""
        return dataclasses.replace(
            self, unused_evicted=self.unused_evicted + int(resident_unused)
        )


@dataclasses.dataclass
class _StreamState:
    """Per-stream predictor training state (the contamination fix)."""

    last: Optional[int] = None
    stride: int = 1
    # the last batch this stream passed to access_many: batches that re-read
    # a previously seen walk prefix (a decode step re-reads the whole KV
    # walk) skip straight to the new suffix instead of retraining it
    tail: Optional[np.ndarray] = None


def train_successors(
    windows: Iterable,
    min_count: int = 2,
    min_frac: float = 0.3,
    max_successors: int = 2,
) -> Dict[int, Tuple[int, ...]]:
    """Learn a confidence-gated successor table from trace windows.

    ``windows`` are ``core.memtrace.TraceWindow``s (or anything with
    ``blocks`` and optional per-access ``stream`` arrays). Transitions are
    extracted PER STREAM within each window — a window interleaves many
    decode slots, and adjacent accesses from different slots are not
    transitions (the cross-stream contamination this module exists to
    avoid). Windows never chain into each other. A successor must be seen
    ``min_count`` times and carry ``min_frac`` of its source's transition
    mass to enter the table; at most ``max_successors`` per source, by
    count. Self-transitions are dropped (prefetching the block just
    accessed is a no-op).

    Returns ``{block: (succ, ...)}`` — plain ints, so the table ships
    verbatim inside fleet epochs.
    """
    pair_list: List[np.ndarray] = []
    for w in windows:
        blk = np.asarray(w.blocks, np.int64).reshape(-1)
        if blk.size < 2:
            continue
        sid = getattr(w, "stream", None)
        s = (
            np.zeros(blk.size, np.int64)
            if sid is None
            else np.asarray(sid, np.int64).reshape(-1)
        )
        order = np.argsort(s, kind="stable")  # stable: preserves in-stream order
        bb, ss = blk[order], s[order]
        same = (ss[:-1] == ss[1:]) & (bb[:-1] != bb[1:])
        if same.any():
            pair_list.append(np.stack([bb[:-1][same], bb[1:][same]], axis=1))
    if not pair_list:
        return {}
    pairs = np.concatenate(pair_list)
    uniq, counts = np.unique(pairs, axis=0, return_counts=True)
    srcs = uniq[:, 0]
    starts = np.flatnonzero(np.r_[True, srcs[1:] != srcs[:-1]])
    ends = np.r_[starts[1:], srcs.size]
    table: Dict[int, Tuple[int, ...]] = {}
    for i0, i1 in zip(starts, ends):
        total = int(counts[i0:i1].sum())
        order = np.argsort(-counts[i0:i1], kind="stable")
        succ = tuple(
            int(uniq[i0 + j, 1])
            for j in order[:max_successors]
            if counts[i0 + j] >= min_count and counts[i0 + j] / total >= min_frac
        )
        if succ:
            table[int(srcs[i0])] = succ
    return table


def train_tenant_successors(
    windows: Iterable,
    stream_tenants: Dict[int, str],
    min_count: int = 2,
    min_frac: float = 0.3,
    max_successors: int = 2,
    default: str = DEFAULT_PARTITION,
) -> Dict[str, Dict[int, Tuple[int, ...]]]:
    """Tenant-partitioned successor training: ``{tenant: {block: (succ,)}}``.

    ``stream_tenants`` maps stream ids (engine seq ids, possibly
    rid-namespaced by the fleet aggregator) to tenant names; streams with
    no mapping train the ``default`` partition. Each window's accesses are
    split by their stream's tenant BEFORE training, so one tenant's
    template chains never enter another tenant's table — the table-side
    half of the isolation whose buffer-side half is the PrefetchEngine's
    fair-share partition eviction. Transitions stay per stream inside each
    partition exactly as in :func:`train_successors`; empty partitions are
    dropped.
    """
    by_tenant: Dict[str, list] = {}
    for w in windows:
        blk = np.asarray(w.blocks, np.int64).reshape(-1)
        if blk.size == 0:
            continue
        sid = getattr(w, "stream", None)
        s = (
            np.zeros(blk.size, np.int64)
            if sid is None
            else np.asarray(sid, np.int64).reshape(-1)
        )
        uniq = np.unique(s)
        tenants = np.array([stream_tenants.get(int(u), default) for u in uniq])
        for t in set(tenants.tolist()):
            m = np.isin(s, uniq[tenants == t])
            by_tenant.setdefault(t, []).append(
                types.SimpleNamespace(blocks=blk[m], stream=s[m])
            )
    out: Dict[str, Dict[int, Tuple[int, ...]]] = {}
    for t, ws in by_tenant.items():
        table = train_successors(
            ws, min_count=min_count, min_frac=min_frac, max_successors=max_successors
        )
        if table:
            out[t] = table
    return out


class PrefetchEngine:
    def __init__(self, predictor: str = "nextline", buffer_blocks: int = 64, degree: int = 2):
        assert predictor in ("nextline", "stride", "markov", "trace", "off")
        self.predictor = predictor
        # PENDING prefetches (LRU, insertion-ordered; value = the tenant
        # partition that issued the entry). An entry is consumed by the
        # demand access it covers — one prefetch pays for one miss, as in
        # any hardware stream buffer — or wasted: evicted by its own
        # partition's overflow, evicted with a tier demotion, or still
        # resident at finalize. Overflow eviction is FAIR-SHARE per
        # partition (see _evict_overflow): a tenant under its share is
        # never evicted by another tenant's flood.
        self.buffer: "collections.OrderedDict[int, str]" = collections.OrderedDict()
        self.capacity = buffer_blocks
        self.degree = degree
        self.stats = PrefetchStats()
        self._streams: Dict[Hashable, _StreamState] = {}
        # markov transitions are trained within streams but the table is
        # shared: a transition observed in one request stream is valid
        # evidence for every stream that walks the same blocks (templates)
        self._markov: dict[int, collections.Counter] = collections.defaultdict(
            collections.Counter
        )
        # trace predictor: trained successor tables, one per tenant
        # partition ({partition: {block: (succ, ...)}}). Flat (legacy)
        # tables live in the default partition — the ``_successors``
        # property below — so single-tenant callers see the old shape.
        self._tables: Dict[str, Dict[int, Tuple[int, ...]]] = {}
        # stream id -> tenant partition (set by the serving engine at
        # admit); unmapped streams use DEFAULT_PARTITION
        self._stream_part: Dict[Hashable, str] = {}
        # live pending-entry count per partition (fair-share accounting)
        self._part_sizes: Dict[str, int] = {}
        # cached numpy view of buffer keys for vectorized membership probes;
        # None -> stale (rebuilt lazily after inserts/evictions)
        self._buf_keys: Optional[np.ndarray] = None

    @property
    def _successors(self) -> Dict[int, Tuple[int, ...]]:
        """The default partition's successor table (legacy flat view)."""
        return self._tables.setdefault(DEFAULT_PARTITION, {})

    # ------------------------------------------------------------------
    def _stream(self, sid: Hashable) -> _StreamState:
        st = self._streams.get(sid)
        if st is None:
            st = self._streams[sid] = _StreamState()
        return st

    def drop_stream(self, sid: Hashable):
        """Forget a finished stream's training tail (slot retirement)."""
        self._streams.pop(sid, None)
        self._stream_part.pop(sid, None)

    def set_stream_partition(self, sid: Hashable, partition: str):
        """Bind a stream to a tenant partition: its pending prefetches
        charge that partition's buffer share and its trace predictions
        come from that partition's table."""
        self._stream_part[sid] = str(partition)

    def _partition_of(self, sid: Hashable) -> str:
        return self._stream_part.get(sid, DEFAULT_PARTITION)

    def load_successors(
        self,
        table: Union[Dict[int, Tuple[int, ...]], Dict[str, Dict[int, Tuple[int, ...]]]],
        merge: bool = False,
    ):
        """Install trained successor tables (fleet push or local training).

        ``table`` is either tenant-partitioned (``{tenant: {block:
        (succ,)}}`` — the fleet/TierEpoch shape) or flat (``{block:
        (succ,)}`` — legacy single-tenant callers; installed into the
        default partition). ``merge=False`` replaces wholesale — the fleet
        table is trained on strictly more data than any local one;
        ``merge=True`` keeps local entries the incoming tables lack,
        per partition.
        """
        nested = bool(table) and all(isinstance(v, dict) for v in table.values())
        incoming = (
            {str(t): dict(tb) for t, tb in table.items()}
            if nested
            else {DEFAULT_PARTITION: dict(table)}
        )
        if merge:
            for part, tb in incoming.items():
                self._tables.setdefault(part, {}).update(tb)
        elif nested:
            self._tables = incoming
        else:
            # legacy flat replace touches only the default partition
            self._tables[DEFAULT_PARTITION] = incoming[DEFAULT_PARTITION]

    # ------------------------------------------------------------------
    def _predict(
        self, block: int, st: _StreamState, part: str = DEFAULT_PARTITION
    ) -> list[int]:
        if self.predictor == "off":
            return []
        if self.predictor == "nextline":
            return [block + i + 1 for i in range(self.degree)]
        if self.predictor == "stride":
            return [block + (i + 1) * st.stride for i in range(self.degree)]
        if self.predictor == "trace":
            # pure trained table, NO heuristic fallback: sequential runs in
            # the training traces put b -> b+1 into the table on their own,
            # so nextline behavior emerges exactly where traces support it —
            # and nowhere else, which is what keeps wasted bandwidth at or
            # below the hardware-style baselines (fig21/fig22's criterion).
            # Partitioned: a stream only ever chases ITS tenant's table.
            table = self._tables.get(part, ())
            return list(table.get(block, ())[: self.degree]) if table else []
        succ = self._markov.get(block)
        if not succ:
            return []
        # confidence gate: only prefetch successors seen repeatedly AND
        # dominating the transition mass — this is what makes real L2
        # prefetchers ACCURATE but LOW-COVERAGE on irregular streams
        # (paper Fig. 22): confident predictions are rare.
        total = sum(succ.values())
        return [
            b
            for b, c in succ.most_common(self.degree)
            if c >= 2 and c / total >= 0.5
        ]

    def predict_chain(
        self,
        block: int,
        stream: Hashable = 0,
        lookahead: int = 4,
        partition: Optional[str] = None,
    ) -> list[int]:
        """Walk the predictor ``lookahead`` transitions ahead of ``block``.

        Pure prediction — no training, no buffer effects. This is the
        serving engine's issue window: chase the successor chain (or
        stride/nextline extrapolation) and return candidate blocks in
        predicted-access order, deduplicated, cycles cut. ``partition``
        overrides the stream's tenant partition — used for queued requests
        whose stream does not exist yet but whose tenant is known.
        """
        st = self._streams.get(stream, _StreamState())
        part = self._partition_of(stream) if partition is None else str(partition)
        out: list[int] = []
        seen = {int(block)}
        cur = int(block)
        for _ in range(max(0, int(lookahead))):
            preds = [p for p in self._predict(cur, st, part) if p >= 0]
            if not preds:
                break
            for p in preds:
                if p not in seen:
                    seen.add(p)
                    out.append(p)
            if preds[0] in out or preds[0] == cur:
                nxt = preds[0]
                if nxt == cur:
                    break
                cur = nxt
            else:
                break  # chain head already visited: cycle
            if len(out) >= lookahead * max(1, self.degree):
                break
        return out[: max(0, int(lookahead)) * max(1, self.degree)]

    # ------------------------------------------------------------------
    def _buffer_keys(self) -> np.ndarray:
        if self._buf_keys is None:
            self._buf_keys = np.fromiter(self.buffer.keys(), np.int64, len(self.buffer))
        return self._buf_keys

    def _dec_part(self, part: str):
        n = self._part_sizes.get(part, 0) - 1
        if n > 0:
            self._part_sizes[part] = n
        else:
            self._part_sizes.pop(part, None)

    def _evict_overflow(self, part: str):
        """Fair-share partition eviction on buffer overflow.

        The inserting partition pays when it is over its fair share
        (capacity / live partitions); otherwise the LARGEST over-share
        partition pays. Either way the victim partition loses its OLDEST
        pending entry. The invariant this buys: a tenant at or under its
        fair share is never evicted by another tenant's prediction flood —
        the cross-tenant interference the shared LRU used to allow.
        """
        fair = self.capacity / max(1, len(self._part_sizes))
        victim_part = part
        if self._part_sizes.get(part, 0) <= fair:
            victim_part = max(self._part_sizes, key=lambda p: self._part_sizes[p])
        victim = next(b for b, p in self.buffer.items() if p == victim_part)
        del self.buffer[victim]
        self._dec_part(victim_part)
        self.stats.unused_evicted += 1

    def _insert(self, block: int, part: str = DEFAULT_PARTITION):
        if block in self.buffer:
            return
        self.stats.total_prefetched += 1
        self.buffer[block] = part
        self._part_sizes[part] = self._part_sizes.get(part, 0) + 1
        self._buf_keys = None
        if len(self.buffer) > self.capacity:
            self._evict_overflow(part)

    def _consume(self, block: int):
        """A demand access lands on a pending prefetch: that prefetch is
        spent (covered one miss — the block is resident/near now, and its
        later accesses are the tier books' business, not ours)."""
        self._dec_part(self.buffer.pop(block))
        self.stats.used_prefetches += 1
        self._buf_keys = None

    def mark_prefetched(self, blocks, partitions=None) -> int:
        """Charge externally executed prefetches (the serving engine's
        far->near page promotions) to the books and track their use.
        ``partitions`` is one partition name for all blocks, or a sequence
        aligned with ``blocks``; omitted, entries land in the default
        partition."""
        b = np.asarray(blocks, np.int64).reshape(-1)
        if partitions is None:
            parts: Sequence[str] = [DEFAULT_PARTITION] * b.size
        elif isinstance(partitions, str):
            parts = [partitions] * b.size
        else:
            parts = [str(p) for p in partitions]
            assert len(parts) == b.size, (len(parts), b.size)
        n = 0
        for blk, part in zip(b.tolist(), parts):
            if int(blk) not in self.buffer:
                self._insert(int(blk), part)
                n += 1
        return n

    def evict(self, blocks) -> int:
        """Evict pending prefetches (e.g. pages demoted out of the near
        tier before any access needed them): pure wasted bandwidth."""
        evicted = 0
        for b in np.asarray(blocks, np.int64).reshape(-1):
            part = self.buffer.pop(int(b), None)
            if part is not None:
                self._dec_part(part)
                evicted += 1
                self.stats.unused_evicted += 1
        if evicted:
            self._buf_keys = None
        return evicted

    def resident_unused(self) -> int:
        """Pending prefetches no demand access has consumed yet."""
        return len(self.buffer)

    def finalized_stats(self) -> PrefetchStats:
        """Stats with still-pending prefetches charged as unused — the
        end-of-run view fig21/fig22 and ServingEngine.stats() report.
        Non-destructive: the live engine keeps running."""
        return self.stats.finalized(self.resident_unused())

    def finalize(self) -> PrefetchStats:
        """Teardown: flush the buffer, charging pending entries for real."""
        self.stats.unused_evicted += len(self.buffer)
        self.buffer.clear()
        self._part_sizes.clear()
        self._buf_keys = None
        return self.stats

    # ------------------------------------------------------------------
    def access(self, block: int, *, is_far: bool, stream: Hashable = 0) -> bool:
        """Demand access to ``block`` on ``stream``. Returns True if a
        pending prefetch covered it (consuming that prefetch).

        A block with a pending prefetch counts as covered whichever tier
        it currently maps to — the prefetch is what moved it near — and
        the prefetch is spent by the hit (one prefetch covers one miss;
        the block's later accesses are near hits in the tier books). A far
        access with no pending prefetch is a demand fetch. Near accesses
        outside the buffer only train the predictor.
        """
        covered = False
        if block in self.buffer:
            self._consume(block)
            covered = True
        elif is_far:
            self.stats.demand_fetches += 1
        # train + issue (per-stream: interleaved callers never contaminate)
        st = self._stream(stream)
        if st.last is not None:
            st.stride = block - st.last or st.stride
            if st.last != block:
                self._markov[st.last][block] += 1
        st.last = block
        st.tail = None  # scalar access invalidates the batch-walk cache
        part = self._partition_of(stream)
        for p in self._predict(block, st, part):
            if 0 <= p:
                self._insert(p, part)
        return covered

    def access_many(self, blocks, far_mask, stream: Hashable = 0) -> int:
        """Batched per-stream access — the decode hot path.

        One call is one contiguous run of ``stream``'s accesses (a decode
        step's full KV page walk). Semantics relative to a scalar
        ``access`` loop, pinned by the differential oracle in
        tests/test_prefetch.py:

        * probes run for the WHOLE batch first (vectorized membership
          against the buffer), then training and prediction issue — a
          prefetch issued by this batch can cover the next batch, not a
          later element of the same one;
        * training and issue skip the batch's longest prefix that exactly
          re-reads the stream's previous batch: a decode step re-walks the
          same growing page list every step, and retraining the unchanged
          prefix each step is how this loop used to burn host time (and
          inflate markov counts) on the hot path. Only the new suffix
          trains and issues.
        """
        b = np.asarray(blocks, np.int64).reshape(-1)
        if b.size == 0:
            return 0
        f = np.broadcast_to(np.asarray(far_mask, bool).reshape(-1), b.shape) \
            if np.asarray(far_mask).size != b.size else np.asarray(far_mask, bool).reshape(-1)
        # --- probe (vectorized): buffer hits are covered, far misses demand
        keys = self._buffer_keys()
        hit = np.isin(b, keys) if keys.size else np.zeros(b.shape, bool)
        covered = int(hit.sum())
        self.stats.demand_fetches += int((f & ~hit).sum())
        if covered:
            for blk in np.unique(b[hit]).tolist():
                self._consume(blk)
        # --- train on the new suffix only
        st = self._stream(stream)
        prev = st.tail
        k = 0
        if (
            prev is not None
            and prev.size
            and b.size >= prev.size
            and np.array_equal(b[: prev.size], prev)
        ):
            k = int(prev.size)
        st.tail = b.copy()
        if k == b.size:
            return covered  # pure re-read: nothing new to train or issue
        new = b[k:]
        if k == 0 and st.last is None:
            srcs, dsts = new[:-1], new[1:]
        else:
            last = st.last if k == 0 else int(prev[-1])
            srcs = np.concatenate([np.asarray([last], np.int64), new[:-1]])
            dsts = new
        for a_, b_ in zip(srcs.tolist(), dsts.tolist()):
            if a_ != b_:
                self._markov[a_][b_] += 1
        if srcs.size:
            d = int(dsts[-1]) - int(srcs[-1])
            st.stride = d or st.stride
        st.last = int(new[-1])
        # --- issue for the newly advanced blocks only
        part = self._partition_of(stream)
        for blk in new.tolist():
            for p in self._predict(int(blk), st, part):
                if 0 <= p:
                    self._insert(p, part)
        return covered
