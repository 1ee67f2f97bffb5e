"""Public paged decode-attention op, routed by device, and the view that
hands the model's per-slot KV cache to it as pages.

``paged_attention(q, k_pages, v_pages, page_table, lengths)`` takes the
shapes of ``repro/kernels/paged_attention/ops.py``: q (B, Hq, d), K/V
pools (Hkv, P, ps, d), page_table (B, pp) int32 and lengths (B,) int32;
it returns (B, Hq, d) in q's dtype, each row attending over the first
``lengths[b]`` positions of its sequence's pages. A length past the
pages' end (pp * ps) sees all of them.

The op takes what the kernel is built for, on every device: q and the
pools f32 or bf16 (K and V of one dtype), head_dim 64 or 128, at most 8
query heads per KV head, an int32 page table and int32 lengths; anything
else raises. CPU tensors take the plain version in ``ref.py``. CUDA
tensors launch the hand-written kernel of ``csrc/paged_attention.cu``
(built at first use): one launch that splits each sequence over the
``ref.split_count(pp * ps, Hkv, B)`` blocks of a thread-block cluster, a
count the wrapper computes and passes, and merges their partials in split
order. The grid comes from shapes alone, so nothing is read back; it reads
the pools through their strides and needs unit stride along head_dim and
16-byte aligned rows. Unlike the TPU op nothing is padded. ``LAUNCHES``
counts kernel launches, and only kernel launches. Meta tensors inside a
cost walk take the shape-only route (``build.shape_only``), which counts
every sequence as long as its pages.
``ref.paged_attention_split_ref`` is the kernel's algorithm in plain
PyTorch, for tests.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, work
from repro_torch.kernels.build import need
from repro_torch.kernels.paged_attention import ref

LAUNCHES = {"paged_attention": 0}
HEAD_DIMS = (64, 128)
MAX_GROUP = 8

_KIND = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _L, _S = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong)


def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    if not getattr(lib, "_declared", False):
        lib.pa_decode.argtypes = [_P, _S, _P, _S, _P, _S, _P, _I, _L, _P, _I, _I, _I, _I, _I,
                                  _I, _I, _I, ctypes.c_float, _P, _P]
        lib.pa_decode.restype = _I
        lib._declared = True
    return lib


def cache_as_pages(k_cache: torch.Tensor, v_cache: torch.Tensor, page_size: int):
    """A layer's contiguous K/V cache (B, Hkv, S, hd) as page pools, without a copy.

    Returns (k_pages, v_pages, page_table). Each pool is a strided view of
    its cache with shape (Hkv, B*Hkv*pp - (Hkv-1)*pp, ps, hd) and strides
    (pp*ps*hd, ps*hd, hd, 1), where pp = S / ps; ``page_table`` (B, pp)
    int32 on the cache's device holds b*Hkv*pp + j, so page
    ``page_table[b, j]`` of head h is positions j*ps .. j*ps+ps-1 of
    ``cache[b, h]``. The last head's last page ends at the cache's last
    element. Raises if S is not a multiple of ``page_size``.
    """
    need(k_cache.ndim == 4 and v_cache.shape == k_cache.shape,
               f"caches must be two (B, Hkv, S, hd) tensors, got {tuple(k_cache.shape)} {tuple(v_cache.shape)}")
    b, hkv, s, hd = k_cache.shape
    ps = int(page_size)
    need(b > 0 and hkv > 0 and ps > 0 and s % ps == 0,
               f"a cache of {s} positions does not split into pages of {ps}")
    pp = s // ps
    n_phys = b * hkv * pp - (hkv - 1) * pp
    views = []
    for name, c in (("k", k_cache), ("v", v_cache)):
        need(c.is_contiguous(), f"the {name} cache must be contiguous")
        end = (c.storage_offset() + c.numel()) * c.element_size()
        need(end <= c.untyped_storage().nbytes(),
                   f"the {name} cache ends past its storage ({end} > {c.untyped_storage().nbytes()} bytes)")
        views.append(torch.as_strided(c, (hkv, n_phys, ps, hd), (pp * ps * hd, ps * hd, hd, 1),
                                      c.storage_offset()))
    dev = k_cache.device
    table = (torch.arange(b, dtype=torch.int32, device=dev) * (hkv * pp))[:, None] \
        + torch.arange(pp, dtype=torch.int32, device=dev)[None, :]
    return views[0], views[1], table


def paged_attention(q, k_pages, v_pages, page_table, lengths):
    """q: (B, Hq, d); k/v_pages: (Hkv, P, ps, d); page_table: (B, pp) int32;
    lengths: (B,) int32 -> (B, Hq, d) in q.dtype."""
    need(q.ndim == 3 and k_pages.ndim == 4 and v_pages.shape == k_pages.shape,
         f"q must be (B, Hq, d) and pages (Hkv, P, ps, d), got {tuple(q.shape)} {tuple(k_pages.shape)} {tuple(v_pages.shape)}")
    b, hq, d = q.shape
    hkv, n_phys, ps, _ = k_pages.shape
    need(k_pages.shape[3] == d, f"pages hold head_dim {k_pages.shape[3]}, q {d}")
    need(hkv > 0 and hq % hkv == 0 and hq // hkv <= MAX_GROUP,
         f"{hq} query heads over {hkv} KV heads: the kernel takes groups of 1..{MAX_GROUP}")
    need(q.dtype in _KIND, f"q must be one of {sorted(map(str, _KIND))}, got {q.dtype}")
    need(k_pages.dtype in _KIND and v_pages.dtype == k_pages.dtype,
         f"pages must share one dtype of {sorted(map(str, _KIND))}, got {k_pages.dtype} {v_pages.dtype}")
    need(d in HEAD_DIMS, f"head_dim {d} is not built: the kernel takes {HEAD_DIMS}")
    need(page_table.ndim == 2 and page_table.shape[0] == b and page_table.dtype == torch.int32,
         f"page_table must be ({b}, pp) int32, got {tuple(page_table.shape)} {page_table.dtype}")
    need(lengths.shape == (b,) and lengths.dtype == torch.int32,
         f"lengths must be ({b},) int32, got {tuple(lengths.shape)} {lengths.dtype}")
    need(n_phys > 0 and ps > 0, "the page pool is empty")
    if build.shape_only(q, k_pages, v_pages, page_table, lengths):
        build.record("paged_attention", work.paged_attention(
            b, hq, hkv, d, q.element_size(), k_pages.element_size(), page_table.shape[1], ps))
        return torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
    if not build.on_cuda("paged_attention", q, k_pages, v_pages, page_table, lengths):
        return ref.paged_attention_ref(q, k_pages, v_pages, page_table, lengths)
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        need(build.vector_aligned(t), f"{name} needs unit stride along head_dim and 16-byte aligned rows")
    need(page_table.is_contiguous() and lengths.is_contiguous(),
         "page_table and lengths must be contiguous")
    return _launch(q, k_pages, v_pages, page_table, lengths,
                   ref.split_count(page_table.shape[1] * ps, hkv, b))


def _launch(q, k_pages, v_pages, page_table, lengths, n_split: int):
    """The kernel on checked CUDA inputs, each sequence split over
    ``n_split`` blocks; the kernel raises for n_split outside 1..8."""
    b, hq, d = q.shape
    hkv, n_phys, ps, _ = k_pages.shape
    out = torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.pa_decode(
            q.data_ptr(), build.strides(q, 2), k_pages.data_ptr(), build.strides(k_pages, 3),
            v_pages.data_ptr(), build.strides(v_pages, 3), page_table.data_ptr(),
            page_table.shape[1], n_phys, lengths.data_ptr(), ps, _KIND[q.dtype],
            _KIND[k_pages.dtype], d, b, hkv, hq // hkv, n_split, 1.0 / math.sqrt(d),
            out.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream,
        )
    build.check(lib, err, "paged_attention")
    LAUNCHES["paged_attention"] += 1
    return out
