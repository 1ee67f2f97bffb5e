"""Int8 error-feedback gradient compression (mirrors repro/optim/compression.py).

Per-block int8 codes with an f32 scale a block of 256 along the flattened
tensor; the residual (g - dequant(quant(g))) is carried to the next step.
The quantizer is deterministic: ``torch.round`` rounds half to even as
``jnp.round`` does, so codes and scales are the reference's bit for bit.
Trees are dicts of tensors, nested or flat.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK = 256


def _pad_len(n: int) -> int:
    return (n + BLOCK - 1) // BLOCK * BLOCK


def compress_int8(x: torch.Tensor):
    """x: any shape f32/bf16 -> (codes int8 (n/B, B), scales f32 (n/B,), shape)."""
    flat = x.float().reshape(-1)
    n = flat.shape[0]
    padded = F.pad(flat, (0, _pad_len(n) - n)).reshape(-1, BLOCK)
    scale = padded.abs().amax(dim=1) / 127.0  # (nb,)
    safe = torch.clamp_min(scale, 1e-12)
    codes = torch.clamp(torch.round(padded / safe[:, None]), -127, 127).to(torch.int8)
    return codes, scale, tuple(x.shape)


def decompress_int8(codes: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (codes.float() * scale[:, None]).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape)


def _map(fn, tree, *rest):
    """``fn`` over the leaves of a dict tree (and of trees of its shape)."""
    return {k: _map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict) else fn(v, *(r[k] for r in rest))
            for k, v in tree.items()}


def ef_compress_tree(grads, residuals):
    """Error-feedback compress a grad tree. Returns (payload, new_residuals):
    payload leaves are (codes, scale, shape) triples; new_residuals carry
    the quantization error to the next step."""

    def one(g, r):
        g = g.float() + r
        codes, scale, shape = compress_int8(g)
        return (codes, scale, shape), g - decompress_int8(codes, scale, shape)

    pairs = _map(one, grads, residuals)
    return _map(lambda p: p[0], pairs), _map(lambda p: p[1], pairs)


def ef_decompress_tree(payload):
    return {k: ef_decompress_tree(v) if isinstance(v, dict) else decompress_int8(*v)
            for k, v in payload.items()}


def init_residuals(params):
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
