"""Public tiered-gather ops: the two-tier composition, routed by device.

``tiered_lookup_segments`` is the serving step's entry point: ONE kernel
launch resolves a whole engine step, every active slot's page ids
concatenated with a per-gather segment index, against the device tier and
slot maps, gathers each row from the near (f32/bf16) or far (int8 + per-row
scale) store with the dequant fused in, and counts a per-segment (near,
far) hit pair on device. Nothing here reads back to the host.

``tiered_lookup_counted`` is the per-call variant (one segment, counters
returned as int32 scalars on the device). ``gather_rows`` is the plain
(optionally dequantizing) row gather behind the flat-mirror oracle.

Dispatch follows the tensors' device and nothing else: CPU tensors take the
plain PyTorch versions in ``ref.py``; CUDA tensors launch the hand-written
kernels of ``csrc/tiered_gather.cu`` (built at first use), and any input the
kernel does not take raises. There is no fallback from one to the other.
``LAUNCHES`` counts kernel launches by name, and only kernel launches.
Meta tensors inside a cost walk take the shape-only route
(``build.shape_only``): empty outputs, the work recorded, no launch.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, work
from repro_torch.kernels.build import need
from repro_torch.kernels.tiered_gather import ref

LAUNCHES = {"tiered_segmented": 0, "tiered_gather": 0, "gather_rows": 0}

_NEAR_KIND = {torch.float32: 0, torch.bfloat16: 1}
_SRC_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = build.load("tiered_gather")
    if not getattr(lib, "_declared", False):
        lib.tg_tiered_lookup.argtypes = [_P, _I, _L, _P, _P, _L, _P, _P, _L,
                                         _P, _P, _I, _I, _I, _P, _P, _P]
        lib.tg_tiered_lookup.restype = _I
        lib.tg_gather_rows.argtypes = [_P, _I, _L, _P, _I, _I, _P, _P, _P]
        lib.tg_gather_rows.restype = _I
        lib._declared = True
    return lib


def _check_tiered(hot, cold_q, cold_scales, tier, slot, ids, seg_of=None):
    need(hot.ndim == 2 and hot.dtype in _NEAR_KIND, f"hot must be (M, D) f32/bf16, got {tuple(hot.shape)} {hot.dtype}")
    d = hot.shape[1]
    need(cold_q.ndim == 2 and cold_q.shape[1] == d and cold_q.dtype == torch.int8,
          f"cold_q must be (M, {d}) int8, got {tuple(cold_q.shape)} {cold_q.dtype}")
    need(cold_scales.numel() == cold_q.shape[0] and cold_scales.dtype == torch.float32,
          f"cold_scales must hold {cold_q.shape[0]} f32 scales, got {tuple(cold_scales.shape)} {cold_scales.dtype}")
    need(tier.ndim == 1 and slot.shape == tier.shape, "tier and slot must be (P,) maps of one length")
    need(tier.dtype == torch.int32 and slot.dtype == torch.int32, "tier and slot must be int32")
    need(ids.ndim == 1 and ids.dtype == torch.int32, f"ids must be (N,) int32, got {tuple(ids.shape)} {ids.dtype}")
    if seg_of is not None:
        need(seg_of.shape == ids.shape and seg_of.dtype == torch.int32, "seg_of must be (N,) int32 like ids")


def _launch_tiered(hot, cold_q, cold_scales, tier, slot, ids, seg_of, n_segments, name):
    """Launch tg_tiered_lookup: (rows (N, D) f32, hits (n_segments, 2) int32)."""
    for t in (hot, cold_q, cold_scales, tier, slot, ids, seg_of):
        need(t is None or t.is_contiguous(), "the kernel takes contiguous tensors only")
    need(tier.shape[0] > 0, "the tier map is empty")
    n, d = ids.shape[0], hot.shape[1]
    dev = hot.device
    rows = torch.empty((n, d), dtype=torch.float32, device=dev)
    hits = torch.empty((n_segments, 2), dtype=torch.int32, device=dev)  # the kernel writes it whole
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.tg_tiered_lookup(
            hot.data_ptr(), _NEAR_KIND[hot.dtype], hot.shape[0],
            cold_q.data_ptr(), cold_scales.data_ptr(), cold_q.shape[0],
            tier.data_ptr(), slot.data_ptr(), tier.shape[0],
            ids.data_ptr(), None if seg_of is None else seg_of.data_ptr(),
            n, d, n_segments, rows.data_ptr(), hits.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    build.check(lib, err, name)
    LAUNCHES[name] += 1
    return rows, hits


def gather_rows(src, ids, scales: Optional[torch.Tensor] = None):
    """src: (M, D); ids: (N,) int32 -> (N, D) f32 (dequantized if scales given)."""
    need(src.ndim == 2 and src.dtype in _SRC_KIND, f"src must be (M, D) f32/bf16/int8, got {tuple(src.shape)} {src.dtype}")
    need(ids.ndim == 1 and ids.dtype == torch.int32, f"ids must be (N,) int32, got {tuple(ids.shape)} {ids.dtype}")
    if scales is not None:
        need(scales.numel() == src.shape[0] and scales.dtype == torch.float32,
              f"scales must hold {src.shape[0]} f32 scales")
    if build.shape_only(src, ids, scales):
        build.record("gather_rows", work.gather_rows(ids.shape[0], src.shape[1], src.element_size(),
                                                     scales is not None))
        return torch.empty((ids.shape[0], src.shape[1]), dtype=torch.float32, device=src.device)
    if not build.on_cuda("tiered gather", src, ids, scales):
        return ref.gather_rows_ref(src, ids, scales)
    n, d = ids.shape[0], src.shape[1]
    rows = torch.empty((n, d), dtype=torch.float32, device=src.device)
    if n == 0:
        return rows
    need(src.shape[0] > 0, "gather from an empty source")
    for t in (src, ids, scales):
        need(t is None or t.is_contiguous(), "the kernel takes contiguous tensors only")
    lib = _lib()
    with torch.cuda.device(src.device):
        err = lib.tg_gather_rows(
            src.data_ptr(), _SRC_KIND[src.dtype], src.shape[0], ids.data_ptr(), n, d,
            None if scales is None else scales.data_ptr(), rows.data_ptr(),
            torch.cuda.current_stream(src.device).cuda_stream,
        )
    build.check(lib, err, "gather_rows")
    LAUNCHES["gather_rows"] += 1
    return rows


def tiered_lookup_counted(hot, cold_q, cold_scales, tier, slot, ids):
    """Two-tier lookup: near rows from ``hot`` (bf16/f32), far rows from the
    int8 ``cold_q``+``cold_scales`` store, selected by ``tier``/``slot`` maps.

    Returns (rows (N, D) f32, near_hits, far_hits), the counts as int32
    scalars on the inputs' device, counted inside the kernel.
    """
    _check_tiered(hot, cold_q, cold_scales, tier, slot, ids)
    if build.shape_only(hot, cold_q, cold_scales, tier, slot, ids):
        build.record("tiered_gather", work.tiered_lookup(ids.shape[0], hot.shape[1], hot.element_size(), 1))
        count = lambda: torch.empty((), dtype=torch.int32, device=hot.device)
        return (torch.empty((ids.shape[0], hot.shape[1]), dtype=torch.float32, device=hot.device),
                count(), count())
    if not build.on_cuda("tiered gather", hot, cold_q, cold_scales, tier, slot, ids):
        return ref.tiered_lookup_counted_ref(hot, cold_q, cold_scales, tier, slot, ids)
    if ids.shape[0] == 0:
        z = torch.zeros((), dtype=torch.int32, device=hot.device)
        return torch.zeros((0, hot.shape[1]), dtype=torch.float32, device=hot.device), z, z.clone()
    rows, hits = _launch_tiered(hot, cold_q, cold_scales.reshape(-1), tier, slot, ids,
                                None, 1, "tiered_gather")
    return rows, hits[0, 0], hits[0, 1]


def tiered_lookup_segments(hot, cold_q, cold_scales, tier, slot, ids, seg_of,
                           n_segments: int):
    """Step-wide ragged lookup: one launch for any number of segments.

    ``ids`` (N,) is the concatenation of every segment's page ids and
    ``seg_of`` (N,) assigns each gather to a segment in [0, n_segments).
    Returns (rows (N, D) f32, seg_hits (n_segments, 2) int32), column 0 the
    near hits and column 1 the far hits, both on the device.
    """
    n_segments = int(n_segments)
    _check_tiered(hot, cold_q, cold_scales, tier, slot, ids, seg_of)
    if build.shape_only(hot, cold_q, cold_scales, tier, slot, ids, seg_of):
        build.record("tiered_segmented", work.tiered_lookup(ids.shape[0], hot.shape[1], hot.element_size(),
                                                            n_segments))
        return (torch.empty((ids.shape[0], hot.shape[1]), dtype=torch.float32, device=hot.device),
                torch.empty((n_segments, 2), dtype=torch.int32, device=hot.device))
    if not build.on_cuda("tiered gather", hot, cold_q, cold_scales, tier, slot, ids, seg_of):
        return ref.tiered_lookup_segments_ref(
            hot, cold_q, cold_scales, tier, slot, ids, seg_of, n_segments
        )
    if ids.shape[0] == 0:
        return (
            torch.zeros((0, hot.shape[1]), dtype=torch.float32, device=hot.device),
            torch.zeros((n_segments, 2), dtype=torch.int32, device=hot.device),
        )
    return _launch_tiered(hot, cold_q, cold_scales.reshape(-1), tier, slot, ids,
                          seg_of, n_segments, "tiered_segmented")
