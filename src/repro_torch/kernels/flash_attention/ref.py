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
P_PARTS = 3  # bf16 parts of p in the bf16 kernel's PV product
TF32_DROP = 13  # mantissa bits that TF32 drops of an f32 (23 - 10)


def flash_attention_ref(q, k, v, *, causal: bool = True, lk_valid: Optional[int] = None,
                        q_offset: Optional[int] = None, return_lse: bool = False):
    """q: (B, Hq, Lq, D); k/v: (B, Hkv, Lk, D); Hq % Hkv == 0 -> (B, Hq, Lq, D).

    With ``return_lse`` also each row's f32 log-sum-exp of its scaled,
    masked scores, (B, Hq, Lq). A row with no valid key has every score at
    -1e30 here and gets about -1e30, where the kernel, which walks no key
    for it, writes 0; no training path has such a row.
    """
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
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float()).reshape(b, hq, lq, d).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1).reshape(b, hq, lq)
    return o


def flash_attention_tiled_ref(q, k, v, *, causal: bool = True, lk_valid: Optional[int] = None,
                              q_offset: Optional[int] = None, block_k: int = 64):
    """The bf16 kernel's algorithm in plain PyTorch, same arguments and result.

    An online softmax over K/V tiles of ``block_k`` rows, as
    ``csrc/flash_attention.cu`` runs it: scores as q·k products summed in
    f32 (for bf16 inputs the products are exact), scaled, masked to
    -1e30; per tile m_new = max(m, tile max), p = exp(s - m_new), l and acc
    rescaled by exp(m - m_new). For bf16 inputs p enters PV as three bf16
    parts, p1 = bf16(p), p2 = bf16(p - p1), p3 = bf16(p - p1 - p2), whose
    products with v are summed in f32: 24 bits of p, as the TPU kernel's f32
    p (two parts, 16 bits, leave errors of some 1e-6 on outputs that cancel
    to 1e-5, past one bf16 step). For f32 inputs p stays f32. The final
    divide is clamped at 1e-30. Tiles past a
    row's causal diagonal change nothing (p = 0, the rescale 1), so every
    row walks every tile up to lk_valid. The card tests hold the kernel to
    it as a second oracle; nothing on the main path calls it.
    """
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    g = hq // hkv
    lk_valid = lk if lk_valid is None else int(lk_valid)
    q_offset = lk_valid - lq if q_offset is None else int(q_offset)
    split = q.dtype == torch.bfloat16
    kv_lim = min(lk_valid, lk)
    qf = q.float().reshape(b, hkv, g, lq, d)
    kf, vf = k.float(), v.float()
    scale = 1.0 / math.sqrt(d)
    qpos = torch.arange(lq, device=q.device)[:, None]
    m = torch.full((b, hkv, g, lq), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, lq, d), device=q.device)
    for k0 in range(0, kv_lim, block_k):
        k1 = min(k0 + block_k, lk)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf[:, :, k0:k1]) * scale
        kpos = torch.arange(k0, k1, device=q.device)[None, :]
        valid = kpos < kv_lim
        if causal:
            valid = valid & (kpos <= qpos + q_offset)
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        vt = vf[:, :, k0:k1]
        if split:
            pv, rest = 0.0, p
            for _ in range(P_PARTS):
                part = rest.to(torch.bfloat16).float()
                pv = pv + torch.einsum("bhgqk,bhkd->bhgqd", part, vt)
                rest = rest - part
        else:
            pv = torch.einsum("bhgqk,bhkd->bhgqd", p, vt)
        acc = acc * corr[..., None] + pv
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(b, hq, lq, d).to(q.dtype)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on f32 values: round to the nearest TF32 (10
    mantissa bits), ties away from zero, by integer operations on the bits:
    add half of the dropped 13 bits' range to the magnitude, then clear
    them (the sign bit is apart, so one add serves both signs)."""
    bits = x.float().contiguous().view(torch.int32)
    half, mask = 1 << (TF32_DROP - 1), ~((1 << TF32_DROP) - 1)
    return ((bits + half) & mask).view(torch.float32)


def tf32_product(eq: str, a, b, products: int = 3):
    """``einsum(eq, a, b)`` as the f32 kernel runs it on the tensor cores:
    each operand split as big = tf32(x), small = tf32(x - big), and the
    products big·big + big·small + small·big summed in f32 (with
    ``products`` = 1 only big·big, with 2 also big·small). Each product of
    two TF32 values is exact in f32, so only the sums round."""
    ab, bb = tf32_rna(a), tf32_rna(b)
    out = torch.einsum(eq, ab, bb)
    if products >= 2:
        out = out + torch.einsum(eq, ab, tf32_rna(b - bb))
    if products >= 3:
        out = out + torch.einsum(eq, tf32_rna(a - ab), bb)
    return out


def flash_attention_tf32_ref(q, k, v, *, causal: bool = True, lk_valid: Optional[int] = None,
                             q_offset: Optional[int] = None, block_k: int = 64,
                             products: int = 3):
    """The f32 kernel's algorithm in plain PyTorch, same arguments and result
    as ``flash_attention_ref`` for f32 inputs.

    The online softmax of ``flash_attention_tiled_ref`` over tiles of
    ``block_k`` keys, with both products on TF32 operands as
    ``tf32_product`` forms them: S = Q K^T and P V each as three products
    of split operands. ``products`` < 3 drops the last of them, to show
    that the split is needed: with one TF32 product the scores carry 11
    bits and the outputs miss 2e-5. The card tests hold the kernel to it
    as a second oracle; nothing on the main path calls it.
    """
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    g = hq // hkv
    lk_valid = lk if lk_valid is None else int(lk_valid)
    q_offset = lk_valid - lq if q_offset is None else int(q_offset)
    kv_lim = min(lk_valid, lk)
    qf = q.float().reshape(b, hkv, g, lq, d)
    kf, vf = k.float(), v.float()
    scale = 1.0 / math.sqrt(d)
    qpos = torch.arange(lq, device=q.device)[:, None]
    m = torch.full((b, hkv, g, lq), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, g, lq, d), device=q.device)
    for k0 in range(0, kv_lim, block_k):
        k1 = min(k0 + block_k, lk)
        s = tf32_product("bhgqd,bhkd->bhgqk", qf, kf[:, :, k0:k1], products) * scale
        kpos = torch.arange(k0, k1, device=q.device)[None, :]
        valid = kpos < kv_lim
        if causal:
            valid = valid & (kpos <= qpos + q_offset)
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = tf32_product("bhgqk,bhkd->bhgqd", p, vf[:, :, k0:k1], products)
        acc = acc * corr[..., None] + pv
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(b, hq, lq, d).to(q.dtype)
