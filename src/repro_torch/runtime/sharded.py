"""Sharded serving: one logical replica whose KV store is split into shards
(mirrors repro/runtime/sharded.py).

KV pages are partitioned PAGE-INTERLEAVED across per-shard
``TieredKVCache`` slices: shard ``s`` owns every page with
``pid % n_shards == s`` (local id ``pid // n_shards``). Interleaving is
what makes the counter algebra work: each page's near/far hit is counted
by exactly one shard, so summing the shards' drained planes reproduces the
unsharded engine's counters bit for bit.

The step budget keeps its shape: one segmented tiered-gather launch per
NON-EMPTY shard per step (a shard with no page in the step's walk launches
nothing) and no host read on the step: the ids are split on the host, each
shard's ids are staged through pinned memory as ``TieredKVCache`` stages
its own, and the shards' rows land in the step's output by an index copy
on the device. Each shard keeps its own device counter plane and drains it
once per profiler window; a clean plane drains without a sync, so a drain
costs one host sync per DIRTY shard.

Drain/merge contract: every shard's plane is a pure sum, so
``drain_counters`` merges the per-shard drains by summation into one dict
of the unsharded shape, and the engine charges the per-shard (near, far)
deltas to ``shard_near_hits{shard=s}`` / ``shard_far_hits{shard=s}``.

Per-shard near capacity is ``min(pages_owned, global_near_capacity)``.
``migrate`` sanitizes the plan against the GLOBAL capacity first, so the
global near set restricted to shard ``s`` fits either bound and
``sanitize_near_ids``'s capacity cut never fires on a shard.

Two layouts, chosen by argument. Without a mesh every shard's store lives
on the engine's one device and the parameters stay whole (ROADMAP A7): an
N-shard engine computes exactly the 1-shard model math, and its tokens
equal the unsharded engine's. Given a mesh of N cards
(``launch.mesh.make_serving_mesh``), the engine is the reference's: ONE
logical replica spanning the cards. Its parameters are placed by
``shard_model_params`` (each leaf's last axis over ``model`` where it
divides) and every step runs under the mesh, so the models' constraints
bind; each card computes on its own shard, and B4/B5 (every family's
attention), B6 (rwkv6) and B7 (zamba2's Mamba2 layers) run on its own
heads, its cache and recurrent states holding only those. Shard ``s`` of the store lives on card ``s`` (``MeshTieredKV``):
only rank ``s`` writes its pages and launches B1 over them, so a step
launches B1 once per non-empty shard summed over the ranks, and
``tiered_verify``'s B3 runs on each rank's own slice. A drain merges the
ranks' planes and books by one integer all-reduce, a pure sum, so every
rank holds the same books, bit for bit. The host logic (admission,
chunking, placement, prefetch) runs identically on every rank, and the
argmax reads logits gathered whole, so every rank emits the same tokens.
A mesh engine dispatches eagerly (``_captures``): its steps issue
collectives, which its decode graphs do not capture.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.device import resolve_device, to_device
from repro_torch.launch import mesh as meshlib
from repro_torch.runtime.serving import EngineConfig, ServingEngine
from repro_torch.runtime.tiered_kv import N_ROLES, TieredKVCache, sanitize_near_ids

# a shard's host books, one row of MeshTieredKV's table; the last two are
# the deltas of the drain that refreshed it
BOOKS = ("near_hits", "far_hits", "lookups", "writes", "moved_rows", "moved_bytes", "dispatches",
         "host_syncs", "drains", "near_count", "drained_near", "drained_far")


def _padded_sum(arrays: List[np.ndarray]) -> np.ndarray:
    """Sum (k_i, 2) int64 arrays of unequal first dims (planes grow on
    demand per shard) into one (max k_i, 2) array."""
    k = max((a.shape[0] for a in arrays), default=0)
    out = np.zeros((k, 2), np.int64)
    for a in arrays:
        out[: a.shape[0]] += a
    return out


class ShardedTieredKV:
    """Per-shard ``TieredKVCache`` slices behind the unsharded interface:
    global page ids in, merged counters out. Every method splits ids by
    ``pid % n_shards``, forwards local ids (``pid // n_shards``) to the
    owning shard, and merges results by pure summation."""

    def __init__(
        self,
        n_pages: int,
        row_dim: int,
        near_capacity: int,
        n_shards: int,
        *,
        near_dtype=torch.float32,
        identity_scales: bool = False,
        counter_slots: int = 0,
        device=None,
    ):
        if n_shards < 1 or n_pages % n_shards != 0:
            raise ValueError(
                f"n_shards={n_shards} must divide n_pages={n_pages}: the "
                "page-interleaved partition owns pages by pid % n_shards"
            )
        self.device = resolve_device(device)
        self.n_pages = n_pages
        self.row_dim = row_dim
        self.near_capacity = near_capacity  # the GLOBAL planner capacity
        self.n_shards = n_shards
        self.identity_scales = identity_scales
        n_local = n_pages // n_shards
        self.shards = [
            TieredKVCache(
                n_local,
                row_dim,
                min(n_local, near_capacity),
                near_dtype=near_dtype,
                identity_scales=identity_scales,
                counter_slots=counter_slots,
                device=self.device,
            )
            for _ in range(n_shards)
        ]
        # per-shard drained (near, far) deltas pending consumption by the
        # engine's shard-labeled metric rows (take_shard_drains)
        self._shard_drained = [{"near": 0, "far": 0} for _ in range(n_shards)]

    # ------------------------------------------------------------------
    # summed host books (the unsharded attribute surface)

    def _sum(self, attr: str) -> int:
        return sum(getattr(sh, attr) for sh in self.shards)

    @property
    def near_hits(self) -> int:
        return self._sum("near_hits")

    @property
    def far_hits(self) -> int:
        return self._sum("far_hits")

    @property
    def lookups(self) -> int:
        return self._sum("lookups")

    @property
    def writes(self) -> int:
        return self._sum("writes")

    @property
    def moved_rows(self) -> int:
        return self._sum("moved_rows")

    @property
    def moved_bytes(self) -> int:
        return self._sum("moved_bytes")

    @property
    def dispatches(self) -> int:
        return self._sum("dispatches")

    @property
    def host_syncs(self) -> int:
        return self._sum("host_syncs")

    @property
    def drains(self) -> int:
        return self._sum("drains")

    @property
    def near_count(self) -> int:
        return self._sum("near_count")

    # ------------------------------------------------------------------
    def _split(self, ids: np.ndarray):
        """(shard, its store, positions in ``ids``, local ids) for every
        shard that owns at least one of ``ids``: the split is host-side."""
        owner = ids % self.n_shards
        for s, sh in enumerate(self.shards):
            idx = np.flatnonzero(owner == s)
            if idx.size:
                yield s, sh, idx, ids[idx] // self.n_shards

    def _idx(self, idx: np.ndarray) -> torch.Tensor:
        return to_device(idx, torch.int64, self.device)

    def _gathered(self, ids: np.ndarray, per_shard) -> torch.Tensor:
        """(N, D) f32 rows: each shard's rows, from ``per_shard(sh, local,
        idx)``, copied to their positions on the device."""
        out = torch.zeros((ids.size, self.row_dim), dtype=torch.float32, device=self.device)
        for _s, sh, idx, local in self._split(ids):
            out.index_copy_(0, self._idx(idx), per_shard(sh, local, idx))
        return out

    def snap(self, rows):
        return self.shards[0].snap(rows)

    def write(self, page_ids, rows):
        ids = np.asarray(page_ids, np.int64).reshape(-1)
        if ids.size == 0:
            return
        if not isinstance(rows, torch.Tensor):
            rows = to_device(np.asarray(rows, np.float32), torch.float32, self.device)
        rows = rows.reshape(ids.size, self.row_dim)
        for _s, sh, idx, local in self._split(ids):
            sh.write(local, rows[self._idx(idx)])

    def ensure_counter_plane(self, n_slots: int, n_tenants: int):
        for sh in self.shards:
            sh.ensure_counter_plane(n_slots, n_tenants)

    def lookup_segments(self, page_ids, seg_of, n_segments: int,
                        slot_idx=None, tenant_idx=None, role_idx=None):
        """Step-wide ragged gather, ONE launch per NON-EMPTY shard and no
        host read. Each shard receives its own pages with the ORIGINAL
        segment indices and the same slot/tenant/role routing vectors, pads
        its own ragged concat and accumulates its own counter plane. Every
        page id lands in exactly one shard, so the per-segment hit pairs
        across shards partition the unsharded pairs."""
        ids = np.asarray(page_ids, np.int64).reshape(-1)
        seg = np.asarray(seg_of, np.int32).reshape(-1)
        if ids.size == 0:
            return torch.zeros((0, self.row_dim), dtype=torch.float32, device=self.device)
        return self._gathered(ids, lambda sh, local, idx: sh.lookup_segments(
            local, seg[idx], n_segments, slot_idx=slot_idx, tenant_idx=tenant_idx,
            role_idx=role_idx))

    def lookup(self, page_ids):
        """Per-call (baseline) path: fan out, merge rows and host-int hits."""
        ids = np.asarray(page_ids, np.int64).reshape(-1)
        hits = [0, 0]

        def one(sh, local, _idx):
            r, n, f = sh.lookup(local)
            hits[0] += n
            hits[1] += f
            return r

        rows = self._gathered(ids, one)
        return rows, hits[0], hits[1]

    def lookup_flat(self, page_ids):
        ids = np.asarray(page_ids, np.int64).reshape(-1)
        return self._gathered(ids, lambda sh, local, _idx: sh.lookup_flat(local))

    def max_abs_error(self, page_ids) -> float:
        ids = np.asarray(page_ids, np.int64).reshape(-1)
        return max((sh.max_abs_error(local) for _s, sh, _i, local in self._split(ids)), default=0.0)

    # ------------------------------------------------------------------
    def drain_counters(self, discard: bool = False) -> dict:
        """Drain every shard's plane independently and merge by summation:
        one host sync per DIRTY shard (a clean shard's drain returns without
        one), once per profiler window. Per-shard (near, far) deltas
        accumulate for ``take_shard_drains``. ``discard=True`` quarantines
        every shard's deltas (``TieredKVCache.drain_counters``): no shard
        book or shard-drain feed is charged."""
        drains = [sh.drain_counters(discard=discard) for sh in self.shards]
        if not discard:
            for s, d in enumerate(drains):
                self._shard_drained[s]["near"] += d["near"]
                self._shard_drained[s]["far"] += d["far"]
        role = np.zeros((N_ROLES, 2), np.int64)
        for d in drains:
            role += np.asarray(d["role"], np.int64)
        return {
            "near": sum(d["near"] for d in drains),
            "far": sum(d["far"] for d in drains),
            "slot": _padded_sum([np.asarray(d["slot"], np.int64) for d in drains]),
            "tenant": _padded_sum([np.asarray(d["tenant"], np.int64) for d in drains]),
            "role": role,
        }

    def take_shard_drains(self) -> List[dict]:
        """Per-shard drained (near, far) deltas since the last take: the feed
        of the engine's shard-labeled counters."""
        out = self._shard_drained
        self._shard_drained = [{"near": 0, "far": 0} for _ in range(self.n_shards)]
        return out

    # ------------------------------------------------------------------
    @property
    def degraded(self) -> bool:
        return all(sh.degraded for sh in self.shards)

    @property
    def plane_dirty(self) -> bool:
        """Whether the next drain reads back a plane this process holds."""
        return any(sh.plane_dirty for sh in self.shards)

    def set_degraded(self, flag: bool):
        """Far-tier-only mode for every shard: one logical replica degrades
        as a unit."""
        for sh in self.shards:
            sh.set_degraded(flag)

    # ------------------------------------------------------------------
    def migrate(self, near_ids, account: bool = True) -> dict:
        """Reconcile every shard with the GLOBAL planned near set, sanitized
        against the global capacity first: shard ``s`` receives the set
        restricted to its own pages, which fits its capacity. Results sum."""
        ids = sanitize_near_ids(near_ids, self.n_pages, self.near_capacity)
        owner = ids % self.n_shards
        out = {"promoted": 0, "demoted": 0, "moved_rows": 0, "moved_bytes": 0}
        for s, sh in enumerate(self.shards):
            res = sh.migrate(ids[owner == s] // self.n_shards, account=account)
            for k in out:
                out[k] += res[k]
        return out

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        tot = self.near_hits + self.far_hits
        return {
            "near_count": self.near_count,
            "near_capacity": self.near_capacity,
            "near_hits": self.near_hits,
            "far_hits": self.far_hits,
            "near_hit_rate": self.near_hits / max(tot, 1),
            "lookups": self.lookups,
            "writes": self.writes,
            "moved_rows": self.moved_rows,
            "moved_bytes": self.moved_bytes,
            "dispatches": self.dispatches,
            "host_syncs": self.host_syncs,
            "drains": self.drains,
            # sharding surface: per-shard near ceilings feed the
            # AutoTierer's TierEpoch.shard_near_capacity
            "shards": self.n_shards,
            "shard_near_capacity": [sh.near_capacity for sh in self.shards],
            "shard_dispatches": [sh.dispatches for sh in self.shards],
            "shard_near_hits": [sh.near_hits for sh in self.shards],
            "shard_far_hits": [sh.far_hits for sh in self.shards],
        }


def _plane_rows(n_segments: int, idx) -> int:
    """The counter-plane rows ``TieredKVCache.lookup_segments`` grows to for
    one call's routing vector (padded with zeros to the real segments)."""
    vec = np.zeros(max(0, int(n_segments) - 1), np.int64)
    if idx is not None:
        vec[: len(idx)] = np.asarray(idx, np.int64)
    return int(vec.max(initial=-1)) + 1


class MeshTieredKV(ShardedTieredKV):
    """The page-interleaved store over a 1-D mesh: this rank holds shard
    ``mesh rank`` only, on its own device, behind the same interface.

    Every rank receives the same calls (the host logic runs identically on
    each). A rank writes, migrates and looks up only the pages it owns, so
    B1 launches once per non-empty shard summed over the ranks; the rows a
    lookup returns are its own pages' (the others' zero). Its counter plane
    grows with every call, whichever pages it owns, so the planes have one
    shape on every rank. The collectives are the drains, the migrations and
    the per-call lookups: each merges by one all-reduce of a vector that
    carries the call's result and every rank's row of host books
    (``BOOKS``; a rank fills its own), so after any of them each rank holds
    every shard's books, and the summed books and per-shard lists are the
    unsharded facade's."""

    def __init__(self, n_pages: int, row_dim: int, near_capacity: int, mesh, *,
                 near_dtype=torch.float32, identity_scales: bool = False, counter_slots: int = 0,
                 device=None):
        n = int(mesh.size())
        if n_pages % n != 0:
            raise ValueError(f"n_shards={n} must divide n_pages={n_pages}: the "
                             "page-interleaved partition owns pages by pid % n_shards")
        self.mesh = mesh
        self.rank = int(mesh.get_local_rank())
        self.device = resolve_device(device)
        self.n_pages = n_pages
        self.row_dim = row_dim
        self.near_capacity = near_capacity  # the GLOBAL planner capacity
        self.n_shards = n
        self.identity_scales = identity_scales
        n_local = n_pages // n
        self.local = TieredKVCache(n_local, row_dim, min(n_local, near_capacity), near_dtype=near_dtype,
                                   identity_scales=identity_scales, counter_slots=counter_slots,
                                   device=self.device)
        self.shards = [self.local]
        self._table = np.zeros((n, len(BOOKS)), np.int64)
        self._shard_drained = [{"near": 0, "far": 0} for _ in range(n)]

    # ------------------------------------------------------------------
    def _exchange(self, extra, drained=(0, 0)) -> np.ndarray:
        """One all-reduce (a sum) of ``extra`` and the table of books with
        this rank's row filled in; refreshes the table, returns the summed
        ``extra``."""
        sh = self.local
        table = np.zeros_like(self._table)
        table[self.rank] = [sh.near_hits, sh.far_hits, sh.lookups, sh.writes, sh.moved_rows,
                            sh.moved_bytes, sh.dispatches, sh.host_syncs, sh.drains, sh.near_count,
                            *drained]
        extra = np.asarray(extra, np.int64).reshape(-1)
        out = meshlib.all_reduce_host(np.concatenate([table.reshape(-1), extra]), self.mesh)
        self._table = out[: table.size].reshape(table.shape)
        return out[table.size:]

    def _sum(self, attr: str) -> int:
        return int(self._table[:, BOOKS.index(attr)].sum())

    def _column(self, attr: str) -> list:
        return [int(x) for x in self._table[:, BOOKS.index(attr)]]

    def _split(self, ids: np.ndarray):
        owned = np.flatnonzero(ids % self.n_shards == self.rank)
        if owned.size:
            yield self.rank, self.local, owned, ids[owned] // self.n_shards

    def lookup_segments(self, page_ids, seg_of, n_segments: int,
                        slot_idx=None, tenant_idx=None, role_idx=None):
        """This rank's share of the step's gather: one launch if it owns any
        of the pages, none otherwise; the rows of its own pages."""
        if np.asarray(page_ids).size:
            self.local.ensure_counter_plane(_plane_rows(n_segments, slot_idx),
                                            _plane_rows(n_segments, tenant_idx))
        return super().lookup_segments(page_ids, seg_of, n_segments, slot_idx=slot_idx,
                                       tenant_idx=tenant_idx, role_idx=role_idx)

    def lookup(self, page_ids):
        rows, near, far = super().lookup(page_ids)
        near, far = (int(x) for x in self._exchange([near, far]))
        return rows, near, far

    def max_abs_error(self, page_ids) -> float:
        local = super().max_abs_error(page_ids)
        return float(meshlib.all_reduce_host([local], self.mesh, op="max", dtype=np.float64)[0])

    def drain_counters(self, discard: bool = False) -> dict:
        """This rank's plane drained, then every rank's merged by one
        all-reduce: the summed planes, the same on every rank."""
        d = self.local.drain_counters(discard=discard)
        slot, tenant = np.asarray(d["slot"], np.int64), np.asarray(d["tenant"], np.int64)
        role = np.asarray(d["role"], np.int64)
        drained = (0, 0) if discard else (d["near"], d["far"])
        flat = self._exchange(np.concatenate([[d["near"], d["far"]], slot.reshape(-1),
                                              tenant.reshape(-1), role.reshape(-1)]), drained)
        a, b = 2 + slot.size, 2 + slot.size + tenant.size
        if not discard:
            for s, (n, f) in enumerate(zip(self._column("drained_near"), self._column("drained_far"))):
                self._shard_drained[s]["near"] += n
                self._shard_drained[s]["far"] += f
        return {"near": int(flat[0]), "far": int(flat[1]), "slot": flat[2:a].reshape(slot.shape),
                "tenant": flat[a:b].reshape(tenant.shape), "role": flat[b:].reshape(role.shape)}

    def migrate(self, near_ids, account: bool = True) -> dict:
        ids = sanitize_near_ids(near_ids, self.n_pages, self.near_capacity)
        res = self.local.migrate(ids[ids % self.n_shards == self.rank] // self.n_shards, account=account)
        keys = ("promoted", "demoted", "moved_rows", "moved_bytes")
        return dict(zip(keys, (int(x) for x in self._exchange([res[k] for k in keys]))))

    def stats(self) -> dict:
        return {**super().stats(), "shard_near_capacity": [self.local.near_capacity] * self.n_shards,
                "shard_dispatches": self._column("dispatches"),
                "shard_near_hits": self._column("near_hits"),
                "shard_far_hits": self._column("far_hits")}


class ShardedServingEngine(ServingEngine):
    """A ``ServingEngine`` whose tiered KV store is split into
    ``ecfg.model_shards`` page-interleaved shards. One logical replica, one
    routing target: its profile export, tenant books and metrics are the
    merged (summed) view of its shards. ``ServingEngine(..., ecfg)`` with
    ``model_shards > 1`` constructs one of these, on one device.

    Given ``mesh``, a 1-D ``("model",)`` mesh of ``model_shards`` ranks
    (``launch.mesh.make_serving_mesh``), the replica spans it, as the
    reference's does: the parameters are placed by ``shard_model_params``,
    every step runs under the mesh, shard ``s`` of the store lives on rank
    ``s`` (``MeshTieredKV``), the cache holds each rank's share of the
    heads (``ModelAPI.init_cache(mesh=)``), and the engine runs on the
    rank's device (``device`` None: the mesh's). Every rank of the mesh
    builds the engine and drives it with the same calls. Serving takes
    every family, and ``sp_activations`` (qwen1.5-110b's shipped config):
    a prefill then splits its queries' sequence over the ranks (B5 at each
    rank's first row), K/V gathered whole, so each rank's cache holds
    every KV head (``ModelAPI.init_cache``)."""

    def __init__(self, api, params, ecfg: EngineConfig, seed: int = 0, recorder=None, mesh=None,
                 device=None):
        n = max(1, int(ecfg.model_shards))
        if ecfg.n_pages % n != 0:
            raise ValueError(f"model_shards={n} must divide n_pages={ecfg.n_pages}")
        self.mesh = mesh
        if mesh is not None:
            if int(mesh.size()) != n:
                raise ValueError(f"mesh model axis {mesh.size()} != model_shards={n}")
            if not meshlib.in_mesh(mesh):
                raise ValueError("this rank is not in the engine's mesh")
            device = meshlib.mesh_device(mesh) if device is None else device
            params = meshlib.shard_model_params(params, mesh)
        super().__init__(api, params, ecfg, seed=seed, recorder=recorder, device=device)

    def _new_cache(self) -> dict:
        return self.api.init_cache(self.ecfg.max_batch, self.ecfg.max_len, device=self.device,
                                   mesh=self.mesh)

    def _captures(self) -> bool:
        return super()._captures() and self.mesh is None

    def _whole_heads(self, kv: torch.Tensor) -> torch.Tensor:
        """Payload vectors with every KV head: a rank holding its share of
        them gathers the others' (the rows are the reference's whole rows)."""
        if self.mesh is None or kv.shape[2] == self.cfg.n_kv_heads:
            return kv
        return meshlib.gathered(kv, self.mesh, 2)

    def _make_tiered_store(self):
        e = self.ecfg
        if self.mesh is not None:
            return MeshTieredKV(e.n_pages, self._payload_dim(), self.placement.near_capacity, self.mesh,
                                identity_scales=e.tiered_identity_scales, counter_slots=e.max_batch,
                                device=self.device)
        return ShardedTieredKV(
            e.n_pages,
            self._payload_dim(),
            self.placement.near_capacity,
            max(1, int(e.model_shards)),
            identity_scales=e.tiered_identity_scales,
            counter_slots=e.max_batch,
            device=self.device,
        )

    def step(self) -> int:
        # the whole step (admit, dispatch, segmented gather, boundary drain)
        # runs under the mesh, so the models' constraints bind against it
        with meshlib.activate(self.mesh):
            return super().step()

    def drain_tier_counters(self):
        d = super().drain_tier_counters()
        if isinstance(self.tiered, ShardedTieredKV):
            # shard-labeled metric rows: drained deltas are pure sums, so
            # these counters merge bit-exactly across cadences and replicas
            for s, delta in enumerate(self.tiered.take_shard_drains()):
                if delta["near"]:
                    self.metrics.counter("shard_near_hits", shard=str(s)).inc(delta["near"])
                if delta["far"]:
                    self.metrics.counter("shard_far_hits", shard=str(s)).inc(delta["far"])
        return d

    def stats(self) -> dict:
        st = super().stats()
        if self.mesh is not None and st["device_tiering"] is not None:
            # each rank probes its own slice: the replica's error is the largest
            st["device_tiering"]["max_read_error"] = float(meshlib.all_reduce_host(
                [self.tiered_max_err], self.mesh, op="max", dtype=np.float64)[0])
        return st
