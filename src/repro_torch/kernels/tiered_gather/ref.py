"""Plain PyTorch versions of the tiered row-gather kernels.

They mirror ``repro/kernels/tiered_gather/ref.py`` op for op. The ops in
``ops.py`` run them for CPU tensors; on the card they are what each CUDA
kernel is held against, bit-exactly. Gather indices follow JAX's indexing:
a negative index counts from the end, and what is still out of range is
clamped. Segment ids outside ``[0, n_segments)`` are dropped as
``jax.ops.segment_sum`` drops them. So an out-of-range id gives the same
answer here, in the kernel and in the JAX reference.
"""
from __future__ import annotations

import torch


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` as JAX indexes: negative indices wrap once, then clamp."""
    n = x.shape[0]
    idx = idx.long()
    return x[torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)]


def gather_rows_ref(src, ids, scales=None):
    """src: (M, D); ids: (N,) int32; scales: optional (M,) row scales.

    Returns (N, D) f32: src[ids] (dequantized by scales if given).
    """
    rows = _take(src, ids).float()
    if scales is not None:
        rows = rows * _take(scales.reshape(-1), ids).float()[:, None]
    return rows


def tiered_lookup_counted_ref(hot, cold_q, cold_scales, tier, slot, ids):
    """Two-tier lookup with the hit split counted alongside.

    hot: (Mh, D) bf16/f32 near-tier rows; cold_q: (Mc, D) int8 far-tier rows
    with per-row ``cold_scales`` (Mc,); ``tier[id]`` in {0=hot, 1=cold};
    ``slot[id]`` = row within its tier. Returns (rows (N, D) f32,
    near_hits, far_hits) as int32 scalars on the inputs' device.
    """
    d = hot.shape[1]
    dev = hot.device
    if ids.shape[0] == 0:
        z = torch.zeros((), dtype=torch.int32, device=dev)
        return torch.zeros((0, d), dtype=torch.float32, device=dev), z, z.clone()
    s = _take(slot, ids).long()
    t = _take(tier, ids).long()
    if hot.shape[0] == 0:
        hot = torch.zeros((1, d), dtype=hot.dtype, device=dev)
    if cold_q.shape[0] == 0:
        cold_q = torch.zeros((1, d), dtype=cold_q.dtype, device=dev)
        cold_scales = torch.ones((1,), dtype=torch.float32, device=dev)
    zero = torch.zeros_like(s)
    h = _take(hot, torch.where(t == 0, s, zero)).float()
    ci = torch.where(t == 1, s, zero)
    c = _take(cold_q, ci).float() * _take(cold_scales.reshape(-1), ci).float()[:, None]
    rows = torch.where((t == 0)[:, None], h, c)
    near = (t == 0).sum().to(torch.int32)
    return rows, near, ids.shape[0] - near


def tiered_lookup_ref(hot, cold_q, cold_scales, tier, slot, ids):
    """Rows-only view of :func:`tiered_lookup_counted_ref`."""
    return tiered_lookup_counted_ref(hot, cold_q, cold_scales, tier, slot, ids)[0]


def tiered_lookup_segments_ref(hot, cold_q, cold_scales, tier, slot, ids,
                               seg_of, n_segments: int):
    """Rows as in :func:`tiered_lookup_ref`, and per-segment (near, far)
    hit pairs as a (n_segments, 2) int32 table. Segments with no gathers
    count (0, 0)."""
    n_segments = int(n_segments)
    dev = hot.device
    if ids.shape[0] == 0:
        return (
            torch.zeros((0, hot.shape[1]), dtype=torch.float32, device=dev),
            torch.zeros((n_segments, 2), dtype=torch.int32, device=dev),
        )
    rows = tiered_lookup_ref(hot, cold_q, cold_scales, tier, slot, ids)
    near = (_take(tier, ids) == 0).to(torch.int32)
    seg = seg_of.long()
    keep = ((seg >= 0) & (seg < n_segments)).to(torch.int32)
    seg = seg.clamp(0, n_segments - 1)
    zeros = torch.zeros(n_segments, dtype=torch.int32, device=dev)
    near_seg = zeros.index_add(0, seg, near * keep)
    far_seg = zeros.index_add(0, seg, (1 - near) * keep)
    return rows, torch.stack([near_seg, far_seg], dim=1)
