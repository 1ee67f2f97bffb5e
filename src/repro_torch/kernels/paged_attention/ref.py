"""Plain PyTorch version of the paged decode-attention kernel.

Mirrors ``repro/kernels/paged_attention/ref.py``: materialize the pages
densely, then run masked single-token attention in f32, returned in q's
dtype. Page ids index as JAX indexes: a negative id counts from the end,
and what is still out of range is clamped.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

NEG_INF = -1e30


def gather_pages(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """pages: (Hkv, P, ps, d); page_table: (B, pp) -> dense (B, Hkv, pp*ps, d)."""
    hkv, n_phys, ps, d = pages.shape
    b, pp = page_table.shape
    idx = page_table.long()
    idx = torch.where(idx < 0, idx + n_phys, idx).clamp(0, n_phys - 1)
    g = pages[:, idx]  # (Hkv, B, pp, ps, d)
    return g.permute(1, 0, 2, 3, 4).reshape(b, hkv, pp * ps, d)


def paged_attention_ref(q, k_pages, v_pages, page_table, lengths):
    """q: (B, Hq, d); pages: (Hkv, P, ps, d); page_table: (B, pp); lengths: (B,).

    Returns (B, Hq, d): decode attention over the first ``lengths[b]``
    tokens of each sequence.
    """
    b, hq, d = q.shape
    hkv = k_pages.shape[0]
    g = hq // hkv
    k = gather_pages(k_pages, page_table).float()
    v = gather_pages(v_pages, page_table).float()
    qf = q.float().reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bhkd->bhgk", qf, k) / math.sqrt(d)
    mask = torch.arange(k.shape[2], device=q.device)[None, :] < lengths.to(q.device)[:, None]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v)
    return o.reshape(b, hq, d).to(q.dtype)


MIN_SPAN = 64  # positions a split takes at the least
TARGET_BLOCKS = 512  # split until the grid has this many (about 4 an SM)


def split_count(cap: int, hkv: int, b: int) -> int:
    """How many blocks the kernel splits each of ``b`` sequences of
    ``cap = pp * ps`` positions over, at ``hkv`` KV heads
    (``build.split_count``): doubled up to 8 while the grid (hkv * b *
    n_split blocks) is under TARGET_BLOCKS and the spans keep at least
    MIN_SPAN positions. The blocks are short and independent until the
    merge, so the grid may take several waves."""
    return build.split_count(cap, MIN_SPAN, lambda n: hkv * b * n < TARGET_BLOCKS)


def paged_attention_split_ref(q, k_pages, v_pages, page_table, lengths, n_split: int):
    """The kernel's algorithm in plain PyTorch: same arguments and result as
    ``paged_attention_ref``, computed as ``csrc/paged_attention.cu`` does.

    The pp * ps positions split into ``n_split`` spans of
    ceil(pp * ps / n_split). Each span leaves a partial over its positions
    below min(length, pp * ps): m its largest score (-1e30 when it has
    none), l = sum exp(s - m) and acc = sum exp(s - m) v, with p = 0 at
    masked positions. The partials merge in split order:
    M = max m_r, L = sum l_r exp(m_r - M), acc = sum acc_r exp(m_r - M),
    and the result is acc / max(L, 1e-30). The card tests hold the kernel
    to it as a second oracle; nothing on the main path calls it.
    """
    b, hq, d = q.shape
    hkv = k_pages.shape[0]
    g = hq // hkv
    k = gather_pages(k_pages, page_table).float()
    v = gather_pages(v_pages, page_table).float()
    cap = k.shape[2]
    span = -(-cap // n_split)
    qf = q.float().reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bhkd->bhgk", qf, k) * (1.0 / math.sqrt(d))
    valid = torch.arange(cap, device=q.device)[None, :] < lengths.to(q.device).clamp(max=cap)[:, None]
    parts = []
    for r in range(n_split):
        lo, hi = min(r * span, cap), min((r + 1) * span, cap)
        vr = valid[:, None, None, lo:hi]
        sr = torch.where(vr, s[..., lo:hi], NEG_INF)
        m = sr.amax(-1) if hi > lo else torch.full(s.shape[:-1], NEG_INF, device=q.device)
        p = torch.where(vr, torch.exp(sr - m[..., None]), 0.0)
        parts.append((m, p.sum(-1), torch.einsum("bhgk,bhkd->bhgd", p, v[:, :, lo:hi])))
    mx = parts[0][0]
    for m, _, _ in parts[1:]:
        mx = torch.maximum(mx, m)
    l_sum = torch.zeros_like(mx)
    acc = torch.zeros_like(parts[0][2])
    for m, l, a in parts:
        f = torch.exp(m - mx)
        l_sum = l_sum + l * f
        acc = acc + a * f[..., None]
    o = acc / torch.clamp(l_sum, min=1e-30)[..., None]
    return o.reshape(b, hq, d).to(q.dtype)
