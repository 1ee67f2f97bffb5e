"""Shared pieces of the plain references: products at a stated precision,
RMS norm, rotary embedding and causal attention, all in float32."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest float8 e4m3 value


class Precision:
    """How the references round the operands of every product.

    ``float32``: not at all (TF32 must be off: ``no_tf32``). ``fp8``: each
    operand rounded to float8 e4m3 under a scale per row of the left
    operand and per column of the right one, then multiplied in float32:
    the precision a step below the bfloat16 the configurations compute in.
    """

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def _round(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        if self.name == "float32":
            return x
        scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` in float32, operands rounded as stated."""
        return self._round(a.float(), -1) @ self._round(b.float(), -2)


def no_tf32():
    """Float32 products in full float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding (rotate-half form) at positions 0..T-1; x (T, H, D)."""
    t, _, d = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * freqs  # (T, D/2)
    cos = torch.cat([ang.cos(), ang.cos()], -1)[:, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[:, None, :]
    x1, x2 = x.chunk(2, -1)
    return x * cos + torch.cat([-x2, x1], -1) * sin


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, prec: Precision) -> torch.Tensor:
    """q (T, Hq, D) over k, v (T, Hkv, D), query head h reading KV head
    h // (Hq / Hkv); softmax(q k^T / sqrt(D)) v under the causal mask."""
    t, hq, d = q.shape
    group = hq // k.shape[1]
    kk = k.repeat_interleave(group, dim=1).transpose(0, 1)  # (Hq, T, D)
    vv = v.repeat_interleave(group, dim=1).transpose(0, 1)
    s = prec.mm(q.transpose(0, 1), kk.transpose(1, 2)) / math.sqrt(d)  # (Hq, T, T)
    mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return prec.mm(p, vv).transpose(0, 1)  # (T, Hq, D)


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor, prec: Precision):
    return prec.mm(F.silu(prec.mm(x, wg)) * prec.mm(x, wu), wd)
