"""Plain PyTorch version of the flash-attention kernel (GQA, causal optional).

Mirrors ``repro/kernels/flash_attention/ref.py``: plain softmax attention
in f32, returned in q's dtype. It adds the kernel's two arguments with the
kernel's meaning (``repro/kernels/flash_attention/kernel.py:88-103``):
keys at ``kpos >= lk_valid`` are masked, and when causal a query row at
``qpos`` sees ``kpos <= qpos + q_offset``. Their defaults (``lk_valid = Lk``,
``q_offset = lk_valid - Lq``) give exactly the JAX reference.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, lk_valid: Optional[int] = None,
                        q_offset: Optional[int] = None):
    """q: (B, Hq, Lq, D); k/v: (B, Hkv, Lk, D); Hq % Hkv == 0 -> (B, Hq, Lq, D)."""
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    g = hq // hkv
    lk_valid = lk if lk_valid is None else int(lk_valid)
    q_offset = lk_valid - lq if q_offset is None else int(q_offset)
    qf = q.float().reshape(b, hkv, g, lq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) / math.sqrt(d)
    kpos = torch.arange(lk, device=q.device)
    valid = (kpos < lk_valid)[None, :]
    if causal:
        valid = valid & (kpos[None, :] <= torch.arange(lq, device=q.device)[:, None] + q_offset)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, hq, lq, d).to(q.dtype)
