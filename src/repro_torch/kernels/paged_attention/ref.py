"""Plain PyTorch version of the paged decode-attention kernel.

Mirrors ``repro/kernels/paged_attention/ref.py``: materialize the pages
densely, then run masked single-token attention in f32, returned in q's
dtype. Page ids index as JAX indexes: a negative id counts from the end,
and what is still out of range is clamped.
"""
from __future__ import annotations

import math

import torch

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
