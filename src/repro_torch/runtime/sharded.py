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

What differs from the reference, on purpose: the reference places the
parameters over a mesh of N devices and runs each step under it. The port
runs on one card, so every shard's store lives on the engine's device and
the parameters stay whole: an N-shard engine computes exactly the 1-shard
model math, and its tokens equal the unsharded engine's. Splitting the
parameters across cards is ROADMAP A11.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.device import resolve_device, to_device
from repro_torch.runtime.serving import EngineConfig, ServingEngine
from repro_torch.runtime.tiered_kv import N_ROLES, TieredKVCache, sanitize_near_ids


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
        self._shard_drained = [{"near": 0, "far": 0} for _ in self.shards]
        return out

    # ------------------------------------------------------------------
    @property
    def degraded(self) -> bool:
        return all(sh.degraded for sh in self.shards)

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


class ShardedServingEngine(ServingEngine):
    """A ``ServingEngine`` whose tiered KV store is split into
    ``ecfg.model_shards`` page-interleaved shards (``ShardedTieredKV``),
    all on the engine's device. One logical replica, one routing target:
    its profile export, tenant books and metrics are the merged (summed)
    view of its shards. ``ServingEngine(..., ecfg)`` with
    ``model_shards > 1`` constructs one of these."""

    def __init__(self, api, params, ecfg: EngineConfig, seed: int = 0, recorder=None,
                 device=None):
        n = max(1, int(ecfg.model_shards))
        if ecfg.n_pages % n != 0:
            raise ValueError(f"model_shards={n} must divide n_pages={ecfg.n_pages}")
        super().__init__(api, params, ecfg, seed=seed, recorder=recorder, device=device)

    def _make_tiered_store(self):
        e = self.ecfg
        return ShardedTieredKV(
            e.n_pages,
            self._payload_dim(),
            self.placement.near_capacity,
            max(1, int(e.model_shards)),
            identity_scales=e.tiered_identity_scales,
            counter_slots=e.max_batch,
            device=self.device,
        )

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
