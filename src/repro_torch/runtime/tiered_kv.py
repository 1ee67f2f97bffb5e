"""Device-resident tiered KV page store (mirrors repro/runtime/tiered_kv.py).

  * ``near``  — (near_capacity, D) f32/bf16 rows, the small high-bandwidth tier;
  * ``far_q`` + ``far_scale`` — (n_pages, D) int8 rows with per-row scales,
    the capacity tier (every page has a reserved far slot, so demotion never
    allocates);
  * ``tier`` / ``slot`` — int32 device maps the tiered-gather kernel reads,
    pushed from their host mirrors when dirty.

Reads go through :meth:`lookup_segments`: ONE kernel launch per engine step
(near gather + far gather with dequant + per-segment near/far hit counting),
with the counts folded into a device-resident counter plane (per-slot,
per-tenant-index, per-role and total accumulators) by ``index_add_``, which
accumulates duplicate indices. :meth:`drain_counters` is the only read of the
plane: one device-to-host copy of all of it, then the plane is zeroed.
Placement pushes go through :meth:`migrate`, real data movement: promotions
dequantize far rows into freed near slots, demotions quantize near rows into
their far slots. ``flat`` mirrors every write at full precision; it is the
differential oracle (``lookup_flat`` / ``max_abs_error``), and with
``identity_scales=True`` rows are snapped to the int8 grid at write time, so
tiered reads are bit-identical to flat reads through any migration history.

Unlike the reference, whose arrays are immutable, the store updates its
device tensors in place (``index_put_``/``index_add_``): the same values,
without a copy of the store per write.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device, to_device, to_host
from repro_torch.kernels.tiered_gather.ops import (
    gather_rows,
    tiered_lookup_counted,
    tiered_lookup_segments,
)

NEAR, FAR = 0, 1
_QMAX = 127.0

# segment roles for mixed prefill/decode dispatches: the counter plane keeps
# a (role, tier) accumulator next to the slot/tenant ones
ROLE_DECODE, ROLE_PREFILL = 0, 1
N_ROLES = 2


def _bucket(n: int, floor: int = 32) -> int:
    """Next power-of-two padding bucket for the ragged concat."""
    return max(floor, 1 << (int(n) - 1).bit_length())


def sanitize_near_ids(near_ids, n_pages: int, capacity: int) -> np.ndarray:
    """Canonical near-set sanitizer shared by the engine's apply_placement
    and TieredKVCache.migrate — the two views MUST apply the same rule or
    placement.tier and the device tier map silently diverge: drop
    out-of-range ids, dedup keeping first-seen order, then cut to capacity."""
    ids = np.asarray(near_ids, np.int64).reshape(-1)
    ids = ids[(ids >= 0) & (ids < n_pages)]
    ids = ids[np.sort(np.unique(ids, return_index=True)[1])]
    return ids[:capacity]


class TieredKVCache:
    def __init__(
        self,
        n_pages: int,
        row_dim: int,
        near_capacity: int,
        *,
        near_dtype=torch.float32,
        identity_scales: bool = False,
        counter_slots: int = 0,
        device=None,
    ):
        assert 0 < near_capacity <= n_pages
        self.device = dev = resolve_device(device)
        self.n_pages = n_pages
        self.row_dim = row_dim
        self.near_capacity = near_capacity
        self.identity_scales = identity_scales
        # device stores
        self.near = torch.zeros((near_capacity, row_dim), dtype=near_dtype, device=dev)
        self.far_q = torch.zeros((n_pages, row_dim), dtype=torch.int8, device=dev)
        self.far_scale = torch.ones((n_pages,), dtype=torch.float32, device=dev)
        self.flat = torch.zeros((n_pages, row_dim), dtype=torch.float32, device=dev)
        # host mirrors of the device maps (slot allocation is host-side
        # bookkeeping, exactly like the page table itself)
        self.tier_host = np.full(n_pages, FAR, np.int32)
        self.slot_host = np.arange(n_pages, dtype=np.int32)  # far slot == pid
        self._free_near = list(range(near_capacity - 1, -1, -1))
        self._maps_dirty = True
        self._tier_dev = None
        self._slot_dev = None
        # host books: drained totals plus per-call sums
        self.near_hits = 0
        self.far_hits = 0
        self.lookups = 0
        self.moved_rows = 0
        self.moved_bytes = 0
        self.writes = 0
        # dispatch/sync budget: kernel launches issued and host round-trips paid
        self.dispatches = 0
        self.host_syncs = 0
        self.drains = 0
        # device-resident counter plane: (k, 2) int32 accumulators of
        # (near, far) hit pairs, read only by drain_counters()
        self.ctr_slot = self._zeros(int(counter_slots))
        self.ctr_tenant = self._zeros(0)
        self.ctr_role = self._zeros(N_ROLES)
        self.ctr_total = torch.zeros((2,), dtype=torch.int32, device=dev)
        self._plane_dirty = False
        # degraded far-tier-only mode: every migrate resolves to the EMPTY
        # near set (demote-only) while set
        self.degraded = False

    def _zeros(self, k: int) -> torch.Tensor:
        return torch.zeros((k, 2), dtype=torch.int32, device=self.device)

    def _ids(self, ids, dtype=torch.int64) -> torch.Tensor:
        return to_device(np.asarray(ids, np.int64).reshape(-1), dtype, self.device)

    # ------------------------------------------------------------------
    @property
    def near_row_bytes(self) -> int:
        """Bytes a promotion writes into the near tier (f32/bf16 row)."""
        return self.row_dim * self.near.element_size()

    @property
    def far_row_bytes(self) -> int:
        """Bytes a demotion writes into the far tier (int8 row + scale)."""
        return self.row_dim + 4

    @property
    def near_count(self) -> int:
        return int((self.tier_host == NEAR).sum())

    @property
    def plane_dirty(self) -> bool:
        """Whether the next (non-discarding) drain reads the plane back: a
        clean plane drains without touching the device."""
        return self._plane_dirty

    def _device_maps(self):
        if self._maps_dirty:
            self._tier_dev = to_device(self.tier_host, torch.int32, self.device)
            self._slot_dev = to_device(self.slot_host, torch.int32, self.device)
            self._maps_dirty = False
        return self._tier_dev, self._slot_dev

    def _quantize(self, rows: torch.Tensor):
        """Per-row symmetric int8 quantization (identity scales: scale=1).
        ``torch.round`` rounds half to even, as ``jnp.round`` does."""
        rows = rows.float()
        if self.identity_scales:
            scale = torch.ones((rows.shape[0],), dtype=torch.float32, device=rows.device)
        else:
            scale = torch.clamp_min(rows.abs().amax(dim=1), 1e-30) / _QMAX
        q = torch.clamp(torch.round(rows / scale[:, None]), -_QMAX, _QMAX).to(torch.int8)
        return q, scale

    def snap(self, rows) -> torch.Tensor:
        """Snap payload rows onto the representable grid: the int8 integer
        grid under identity scales, unchanged otherwise."""
        if not isinstance(rows, torch.Tensor):
            rows = to_device(np.asarray(rows, np.float32), torch.float32, self.device)
        rows = rows.float()
        if self.identity_scales:
            rows = torch.clamp(torch.round(rows), -_QMAX, _QMAX)
        return rows

    # ------------------------------------------------------------------
    def write(self, page_ids, rows):
        """Write payload rows for ``page_ids`` into their CURRENT tier.

        Near pages land in their near slot at full precision; far pages are
        quantized into their reserved far slot. ``flat`` always receives the
        full-precision row. Duplicate ids keep the last row.
        """
        pids = np.asarray(page_ids, np.int64).reshape(-1)
        rows = self.snap(rows).reshape(pids.size, self.row_dim)
        if pids.size == 0:
            return
        # keep the LAST write per page id
        _, last = np.unique(pids[::-1], return_index=True)
        keep = (pids.size - 1) - last
        pids, rows = pids[keep], rows[self._ids(keep)]
        self.flat[self._ids(pids)] = rows
        near_mask = self.tier_host[pids] == NEAR
        if near_mask.any():
            nrows = rows[self._ids(np.flatnonzero(near_mask))]
            self.near[self._ids(self.slot_host[pids[near_mask]])] = nrows.to(self.near.dtype)
        if (~near_mask).any():
            frows = rows[self._ids(np.flatnonzero(~near_mask))]
            q, scale = self._quantize(frows)
            fp = self._ids(pids[~near_mask])
            self.far_q[fp] = q
            self.far_scale[fp] = scale
        self.writes += int(pids.size)

    # ------------------------------------------------------------------
    def lookup(self, page_ids):
        """Gather payload rows for ``page_ids`` through the tiered kernel.
        Returns (rows (N, D) f32, near_hits int, far_hits int): the hit split
        counted on device and read back per call (one host sync)."""
        ids = self._ids(page_ids, torch.int32)
        tier, slot = self._device_maps()
        rows, near, far = tiered_lookup_counted(
            self.near, self.far_q, self.far_scale, tier, slot, ids
        )
        n, f = (int(x) for x in to_host(torch.stack([near, far])))
        self.near_hits += n
        self.far_hits += f
        self.lookups += 1
        self.dispatches += 1
        self.host_syncs += 1
        return rows, n, f

    # ------------------------------------------------------------------
    def ensure_counter_plane(self, n_slots: int, n_tenants: int):
        """Grow the counter plane to at least (n_slots, n_tenants) rows,
        preserving any undrained counts."""

        def grow(buf, k):
            if buf.shape[0] >= k:
                return buf
            return torch.cat([buf, self._zeros(k - buf.shape[0])])

        self.ctr_slot = grow(self.ctr_slot, int(n_slots))
        self.ctr_tenant = grow(self.ctr_tenant, int(n_tenants))

    def lookup_segments(self, page_ids, seg_of, n_segments: int,
                        slot_idx=None, tenant_idx=None, role_idx=None):
        """Step-wide ragged gather: ONE kernel launch, ZERO host syncs.

        ``page_ids`` concatenates every segment's pages; ``seg_of`` assigns
        each gather to a segment in [0, n_segments - 1) — the last segment
        index is reserved for shape-bucketing padding and its counts are
        discarded. ``slot_idx``/``tenant_idx``/``role_idx`` (one index per
        real segment) route the per-segment (near, far) hit pairs into the
        device counter plane; omitted, ``role_idx`` charges the decode row.

        Returns the gathered rows (N, D) f32 on the device.
        """
        ids = np.asarray(page_ids, np.int64).reshape(-1)
        seg = np.asarray(seg_of, np.int32).reshape(-1)
        assert seg.size == ids.size
        n_segments = int(n_segments)
        # the last segment is the padding sink: real gathers assigned there
        # would be silently dropped from the books, so fail loudly instead
        assert int(seg.max(initial=-1)) < n_segments - 1, (
            f"seg_of uses segment {int(seg.max(initial=-1))} but n_segments="
            f"{n_segments} reserves the last index for padding"
        )
        if ids.size == 0:
            return torch.zeros((0, self.row_dim), dtype=torch.float32, device=self.device)
        # pad the ragged concat to a power-of-two bucket; padding gathers
        # page 0 into the sacrificial last segment, whose counts are dropped
        pad = _bucket(ids.size) - ids.size
        if pad:
            ids = np.concatenate([ids, np.zeros(pad, np.int64)])
            seg = np.concatenate([seg, np.full(pad, n_segments - 1, np.int32)])
        tier, slot = self._device_maps()
        rows, seg_hits = tiered_lookup_segments(
            self.near, self.far_q, self.far_scale, tier, slot,
            self._ids(ids, torch.int32), self._ids(seg, torch.int32), n_segments,
        )
        live = seg_hits[: n_segments - 1]
        k = live.shape[0]
        slot_vec = np.zeros(k, np.int64)
        tenant_vec = np.zeros(k, np.int64)
        role_vec = np.zeros(k, np.int64)  # default: everything is decode
        if slot_idx is not None:
            slot_vec[: len(slot_idx)] = np.asarray(slot_idx, np.int64)
        if tenant_idx is not None:
            tenant_vec[: len(tenant_idx)] = np.asarray(tenant_idx, np.int64)
        if role_idx is not None:
            role_vec[: len(role_idx)] = np.asarray(role_idx, np.int64)
            assert role_vec.min() >= 0 and role_vec.max() < N_ROLES, role_vec
        self.ensure_counter_plane(int(slot_vec.max(initial=-1)) + 1,
                                  int(tenant_vec.max(initial=-1)) + 1)
        # padded segments carry zero hits, so scatter-adding them is a no-op
        self.ctr_slot.index_add_(0, self._ids(slot_vec), live)
        self.ctr_tenant.index_add_(0, self._ids(tenant_vec), live)
        self.ctr_role.index_add_(0, self._ids(role_vec), live)
        self.ctr_total += live.sum(dim=0, dtype=torch.int32)
        self._plane_dirty = True
        self.lookups += 1
        self.dispatches += 1
        return rows[: ids.size - pad] if pad else rows

    def drain_counters(self, discard: bool = False) -> dict:
        """The ONE host read of the counter plane: one device-to-host copy of
        the per-slot / per-tenant / per-role / total accumulators, which are
        then zeroed, and the totals folded into the host hit books.

        Idempotent: a clean plane returns all-zero deltas and charges
        nothing. ``discard=True`` quarantines the deltas: they are returned
        and the plane is zeroed, but nothing is folded into the host books
        or charged as a host sync.
        """
        n_slots, n_tenants = self.ctr_slot.shape[0], self.ctr_tenant.shape[0]
        if not self._plane_dirty:
            return {
                "near": 0,
                "far": 0,
                "slot": np.zeros((n_slots, 2), np.int64),
                "tenant": np.zeros((n_tenants, 2), np.int64),
                "role": np.zeros((N_ROLES, 2), np.int64),
            }
        planes = (self.ctr_slot, self.ctr_tenant, self.ctr_role, self.ctr_total)
        flat = to_host(torch.cat([p.reshape(-1) for p in planes])).astype(np.int64)
        a, b = 2 * n_slots, 2 * (n_slots + n_tenants)
        slot_c = flat[:a].reshape(n_slots, 2)
        tenant_c = flat[a:b].reshape(n_tenants, 2)
        role_c = flat[b:b + 2 * N_ROLES].reshape(N_ROLES, 2)
        total = flat[b + 2 * N_ROLES:]
        for p in planes:
            p.zero_()
        self._plane_dirty = False
        n, f = int(total[0]), int(total[1])
        if not discard:
            self.near_hits += n
            self.far_hits += f
            self.host_syncs += 1
            self.drains += 1
        return {"near": n, "far": f, "slot": slot_c, "tenant": tenant_c, "role": role_c}

    def lookup_flat(self, page_ids):
        """The flat-buffer gather (differential oracle)."""
        return gather_rows(self.flat, self._ids(page_ids, torch.int32))

    def max_abs_error(self, page_ids) -> float:
        """Tiered-vs-flat read divergence for ``page_ids`` (0.0 under
        identity scales). Bypasses the hit counters."""
        ids = np.asarray(page_ids, np.int64).reshape(-1)
        if ids.size == 0:
            return 0.0
        tier, slot = self._device_maps()
        rows, _, _ = tiered_lookup_counted(
            self.near, self.far_q, self.far_scale, tier, slot, self._ids(ids, torch.int32)
        )
        return float(to_host((rows - self.lookup_flat(ids)).abs().max()))

    # ------------------------------------------------------------------
    def set_degraded(self, flag: bool):
        """Flip far-tier-only mode; callers follow with ``migrate(())``."""
        self.degraded = bool(flag)

    # ------------------------------------------------------------------
    def migrate(self, near_ids, account: bool = True) -> dict:
        """Reconcile the device tiers with a planned near set — REAL moves.

        Demotions run first (quantize near row -> its reserved far slot,
        freeing the near slot), then promotions (dequantize far row -> a
        free near slot). Returns {"promoted", "demoted", "moved_rows",
        "moved_bytes"}. ``account=False`` skips the moved_rows/moved_bytes
        books (the constructor-time initial fill). While ``degraded`` the
        planned near set is forced EMPTY.
        """
        want = np.zeros(self.n_pages, bool)
        if not self.degraded:
            want[sanitize_near_ids(near_ids, self.n_pages, self.near_capacity)] = True
        cur = self.tier_host == NEAR
        demote = np.flatnonzero(cur & ~want)
        promote = np.flatnonzero(~cur & want)
        if demote.size:
            d_slots = self.slot_host[demote].copy()
            q, scale = self._quantize(self.near[self._ids(d_slots)].float())
            dem = self._ids(demote)
            self.far_q[dem] = q
            self.far_scale[dem] = scale
            self.tier_host[demote] = FAR
            self.slot_host[demote] = demote  # far slot == page id
            self._free_near.extend(int(s) for s in d_slots)
        if promote.size:
            assert len(self._free_near) >= promote.size, "near tier overflow"
            slots = np.array([self._free_near.pop() for _ in range(promote.size)], np.int32)
            pro = self._ids(promote)
            rows = self.far_q[pro].float() * self.far_scale[pro][:, None]
            self.near[self._ids(slots)] = rows.to(self.near.dtype)
            self.tier_host[promote] = NEAR
            self.slot_host[promote] = slots
        if demote.size or promote.size:
            self._maps_dirty = True
        moved = int(promote.size + demote.size)
        moved_bytes = int(
            promote.size * self.near_row_bytes + demote.size * self.far_row_bytes
        )
        if account:
            self.moved_rows += moved
            self.moved_bytes += moved_bytes
        return {
            "promoted": int(promote.size),
            "demoted": int(demote.size),
            "moved_rows": moved,
            "moved_bytes": moved_bytes,
        }

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """Host-book snapshot (drained counts only)."""
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
        }
