"""A frozen copy of ``repro_torch.kernels.work``: each kernel's work from
its shapes, ``(bytes, operations, peak)``; the least time the card could
take for a call is the larger of ``bytes / peaks.HBM_BW`` and
``operations / peak``. Data-dependent counts take the data (page ids and
tier map, lengths). ``bench/tests/test_bench_frozen.py`` holds every
function here to the program's on a few shapes."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from bench.frozen import peaks as hw

CHUNK = 32  # the scan kernels' chunk
TF32_PRODUCTS = 3  # TF32 products the f32 flash kernel takes for one f32-exact product


def least_seconds(work) -> float:
    """The least time the card could take for ``work`` = (bytes, ops, peak)."""
    nbytes, ops, peak = work
    return max(nbytes / hw.HBM_BW, ops / peak)


def lookup_bucket(n: int, floor: int = 32) -> int:
    """The tier store's padding of a step's ragged id list (the store's
    ``_bucket``): the next power of two, at least ``floor``."""
    return max(floor, 1 << (int(n) - 1).bit_length())

def tiered_lookup(n: int, d: int, near_itemsize: int, n_segments: int,
                  ids: Optional[np.ndarray] = None, tier: Optional[np.ndarray] = None):
    """B1 (``tiered_lookup_segments``) and B2 (``tiered_lookup_counted``, one
    segment): the ids and segment ids, the tier and slot entries of each
    distinct page, each distinct selected row once (a far row with its
    scale), the (N, D) f32 rows and the hit table written; the operations
    one dequant multiply an element of every far gather. Without ``ids``
    and ``tier`` each of the ``n`` gathers is its own near page."""
    if ids is None:
        pages_n, n_near, n_far, far_gathers = n, n, 0, 0
    else:
        pages = np.unique(ids)
        pages_n = pages.size
        n_near = int((tier[pages] == 0).sum())
        n_far = pages_n - n_near
        far_gathers = ids.size - int((tier[ids] == 0).sum())
    reads = n * 4 * 2 + pages_n * 8 + n_near * d * near_itemsize + n_far * (d + 4)
    writes = n * d * 4 + n_segments * 2 * 4
    return float(reads + writes), float(far_gathers) * d, hw.PEAK_FLOPS_FP32


def gather_rows(n: int, d: int, src_itemsize: int, scaled: bool, ids: Optional[np.ndarray] = None):
    """B3 (``gather_rows``): the ids, each distinct source row once (with its
    scale when scaled), the (N, D) f32 rows written; one multiply an element
    when scaled. Without ``ids`` every gather is a distinct row."""
    uniq = n if ids is None else int(np.unique(ids).size)
    nbytes = n * 4 + uniq * (d * src_itemsize + (4 if scaled else 0)) + n * d * 4
    return float(nbytes), float(n * d if scaled else 0), hw.PEAK_FLOPS_FP32


def flash_attention(b: int, hq: int, hkv: int, lq: int, lk: int, d: int, itemsize: int, causal: bool,
                    q_offset: int = 0, lk_valid: Optional[int] = None, return_lse: bool = False):
    """B5 (``flash_attention``): q, k, v read and o written once (and the lse
    when asked for); the operations QK^T and PV over the (query, key) pairs
    the mask keeps, 4 d a pair. bf16 runs on the tensor cores at their
    bf16 peak; f32 as ``TF32_PRODUCTS`` TF32 products a product, so at a
    third of the TF32 peak."""
    lk_valid = lk if lk_valid is None else lk_valid
    nbytes = 2 * b * hq * lq * d * itemsize + 2 * b * hkv * lk * d * itemsize
    if return_lse:
        nbytes += b * hq * lq * 4
    if not causal:
        pairs = lq * lk_valid
    elif q_offset == 0 and lq <= lk_valid:
        pairs = lq * (lq + 1) / 2
    else:  # row i sees the keys j <= q_offset + i below lk_valid
        pairs = int(np.clip(np.arange(lq, dtype=np.int64) + q_offset + 1, 0, lk_valid).sum())
    peak = hw.PEAK_FLOPS_BF16 if itemsize == 2 else hw.PEAK_FLOPS_TF32 / TF32_PRODUCTS
    return float(nbytes), 4.0 * b * hq * d * pairs, peak


def paged_attention(b: int, hq: int, hkv: int, d: int, q_itemsize: int, kv_itemsize: int,
                    pages_per_seq: int, page_size: int, lengths: Optional[Sequence[int]] = None):
    """B4 (``paged_attention``): the K/V of every position a row sees, q read
    and o written, the page table and the lengths; 4 d operations a (query
    head, position) pair. A row sees min(length, its pages' positions);
    without ``lengths`` every row sees all of them (a cache filled to its
    end, as the reference's decode cell). An f32 query runs on the CUDA
    cores, a bf16 one at the bf16 peak."""
    span = pages_per_seq * page_size
    seen = b * span if lengths is None else sum(min(int(x), span) for x in lengths)
    nbytes = float(2 * seen * hkv * d * kv_itemsize + 2 * b * hq * d * q_itemsize
                   + b * pages_per_seq * 4 + b * 4)
    peak = hw.PEAK_FLOPS_FP32 if q_itemsize == 4 else hw.PEAK_FLOPS_BF16
    return nbytes, 4.0 * hq * d * seen, peak


def _chunks(t: int):
    return [min(CHUNK, t - c) for c in range(0, t, CHUNK)]


def wkv6(b: int, t: int, h: int, hd: int, with_state: bool, return_states: bool = False):
    """B6 (``wkv6_chunked``): r, k, v, lw read and y written once, u, the
    state written (and read when given), and the chunk-entry states when
    asked for; the operations those of the kernel's chunked form on these
    shapes, an exp counted as one: per chunk of n tokens the cumulative
    sums, the n(n-1)/2 off-diagonal A terms of hd (sub, exp, mul, fma) and
    the n diagonal ones, the decayed r and k, y = A v + r~ S and the state
    update. f32 on the CUDA cores."""
    nbytes = 4.0 * (5 * b * t * h * hd + h * hd + (2 if with_state else 1) * b * h * hd * hd)
    ops = 0.0
    for n in _chunks(t):
        ops += (n + 1) * hd + n * (n - 1) / 2 * hd * 5 + n * hd * 3 + n * hd * 5
        ops += n * (n + 1) / 2 * hd * 2 + n * hd * hd * 2 + hd * hd * (1 + 2 * n)
    if return_states:
        nbytes += 4.0 * b * h * -(-t // CHUNK) * hd * hd
    return nbytes, ops * b * h, hw.PEAK_FLOPS_FP32


def ssd(b: int, t: int, h: int, p: int, n_state: int, with_state: bool, return_states: bool = False):
    """B7 (``ssd_chunked``): x read and y written once, dt, B, C, A, D read,
    the state written (and read when given), and the chunk-entry states
    when asked for; the operations the function needs in the chunked form,
    an exp counted as one. Per chunk of n tokens: the Gram matrix C B^T
    over its n(n+1)/2 causal pairs once, shared by the heads; per head the
    decays (dt A, its cumulative sum and their exps), the n(n+1)/2 segment
    weights G and their product with the Gram matrix, ((C B^T) o G) x,
    C S_in^T scaled and plus D x, x o w once, and the state update
    exp(.) S_in + (x o w)^T B. (The kernel, as the TPU kernel, forms the
    Gram matrix in every head and multiplies x by w again inside its N
    loop; that redundant work is not counted.) f32 on the CUDA cores."""
    nbytes = 4.0 * (2 * b * t * h * p + b * t * h + 2 * b * t * n_state + 2 * h
                    + (2 if with_state else 1) * b * h * p * n_state)
    ops = 0.0
    for n in _chunks(t):
        tri = n * (n + 1) / 2
        per_head = (6 * n + 4 * tri + 2 * tri * p + 2 * n * p * n_state + 4 * n * p
                    + n * p + p * n_state * (2 * n + 1))
        ops += 2 * n_state * tri + h * per_head
    if return_states:
        nbytes += 4.0 * b * h * -(-t // CHUNK) * p * n_state
    return nbytes, ops * b, hw.PEAK_FLOPS_FP32
