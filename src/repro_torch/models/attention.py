"""GQA attention layer: prefill/decode application (mirrors repro/models/attention.py).

Layout: projections (drawn by ``transformer.init_attn``) are stored
flat and in JAX's (in, out) order — wq: (D, Hq*hd), wk/wv: (D, Hkv*hd),
wo: (Hq*hd, D) — so ``x @ W`` mirrors the reference's einsums. KV cache per layer: k/v (B, Hkv, S, hd) plus
per-sequence lengths (B,). The apply functions take the layer's weights as
a dict of tensors already cast to the compute dtype.

Attention itself follows the tensors' device. On the CPU it is the eager
``common.attention_chunked`` / ``common.attention_decode``, which mirror
the reference op for op. On the card prefill runs the hand-written flash
kernel and decode the paged kernel over the cache itself, viewed as pages
(``kernels/flash_attention``, ``kernels/paged_attention``); a CUDA tensor
the kernel refuses raises.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import cache_as_pages, paged_attention
from repro_torch.models import common


def _project_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor):
    b, l, _ = x.shape
    hd = cfg.head_dim
    q = common.matmul_f32(x, p["wq"]).to(x.dtype)
    k = common.matmul_f32(x, p["wk"]).to(x.dtype)
    v = common.matmul_f32(x, p["wv"]).to(x.dtype)
    if cfg.qkv_bias:
        q, k, v = q + p["bq"].to(q.dtype), k + p["bk"].to(k.dtype), v + p["bv"].to(v.dtype)
    q = q.reshape(b, l, cfg.n_heads, hd).transpose(1, 2)
    k = k.reshape(b, l, cfg.n_kv_heads, hd).transpose(1, 2)
    v = v.reshape(b, l, cfg.n_kv_heads, hd).transpose(1, 2)
    return q, k, v


def _rope(cfg: ModelConfig, q, k, positions):
    if cfg.rope_theta <= 0:
        return q, k
    return (common.apply_rope(q, positions, cfg.rope_theta),
            common.apply_rope(k, positions, cfg.rope_theta))


def _out_proj(p: dict, x_dtype, o: torch.Tensor) -> torch.Tensor:
    b, h, l, hd = o.shape
    o = o.transpose(1, 2).reshape(b, l, h * hd)
    return common.matmul_f32(o, p["wo"]).to(x_dtype)


def attend(q, k, v, *, causal: bool, block_k: int) -> torch.Tensor:
    """Full-sequence attention, (B, Hq, L, hd) -> (B, Hq, L, hd): the flash
    kernel on the card (every key valid, q row 0 at position 0), the eager
    online-softmax reference on the CPU."""
    if q.is_cuda:
        return flash_attention(q, k, v, causal=causal, lk_valid=k.shape[2], q_offset=0)
    return common.attention_chunked(q, k, v, causal=causal, block_k=block_k)


def apply_train(p: dict, cfg: ModelConfig, x, positions, *, causal: bool = True,
                block_k: int = 1024) -> torch.Tensor:
    """Full-sequence attention (forward without cache return)."""
    q, k, v = _project_qkv(p, cfg, x)
    q, k = _rope(cfg, q, k, positions)
    o = attend(q, k, v, causal=causal, block_k=block_k)
    return _out_proj(p, x.dtype, o)


def apply_prefill(p: dict, cfg: ModelConfig, x, positions, max_len: int, block_k: int = 1024):
    """As apply_train but also returns the (padded-to-max_len) KV for caching."""
    q, k, v = _project_qkv(p, cfg, x)
    q, k = _rope(cfg, q, k, positions)
    o = attend(q, k, v, causal=True, block_k=block_k)
    l = x.shape[1]
    if max_len > l:
        k = F.pad(k, (0, 0, 0, max_len - l))
        v = F.pad(v, (0, 0, 0, max_len - l))
    return _out_proj(p, x.dtype, o), (k, v)


def _write_at(cache: torch.Tensor, lengths: torch.Tensor, new: torch.Tensor,
              active: Optional[torch.Tensor] = None):
    """cache[b, :, lengths[b], :] = new[b], in place. A position past the
    cache's end is dropped, as JAX drops an out-of-range update, and so is
    every row b with ``active[b]`` False when a (B,) bool ``active`` is
    given; the write is a select, so it needs no host read of ``lengths``."""
    s = cache.shape[2]
    idx = torch.arange(cache.shape[0], device=cache.device)
    pos = lengths.long().clamp(max=s - 1)
    keep = lengths < s if active is None else (lengths < s) & active
    cache[idx, :, pos, :] = torch.where(keep[:, None, None], new.to(cache.dtype),
                                        cache[idx, :, pos, :])


def apply_decode(p: dict, cfg: ModelConfig, x, k_cache, v_cache, lengths, page_size: int = 16,
                 active: Optional[torch.Tensor] = None):
    """One-token decode. x: (B, 1, D); caches (B, Hkv, S, hd); lengths (B,).

    Writes the new K/V at position ``lengths`` per sequence IN PLACE into
    ``k_cache``/``v_cache``, except on the rows where a given (B,) bool
    ``active`` is False, whose caches stay as they were; attention sees
    ``lengths + 1`` valid entries. On the card the paged kernel walks the
    cache as pages of ``page_size`` positions (the engine's page size; S
    must be a multiple of it); the CPU path ignores it. Returns the
    attention output (B, 1, D).
    """
    q, k, v = _project_qkv(p, cfg, x)
    positions = lengths[:, None].to(torch.int32)  # (B, 1)
    q, k = _rope(cfg, q, k, positions)
    _write_at(k_cache, lengths, k[:, :, 0, :], active)
    _write_at(v_cache, lengths, v[:, :, 0, :], active)
    o = attend_decode(q, k_cache, v_cache, lengths + 1, page_size)
    return _out_proj(p, x.dtype, o)


def _read_at(cache: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """cache[b, :, lengths[b], :] for every row b (clamped to the cache's end,
    as ``_write_at`` clamps)."""
    idx = torch.arange(cache.shape[0], device=cache.device)
    return cache[idx, :, lengths.long().clamp(max=cache.shape[2] - 1), :]


def apply_decode_every_row(p: dict, cfg: ModelConfig, x, k_cache, v_cache, lengths,
                           page_size: int = 16, active: Optional[torch.Tensor] = None):
    """``apply_decode`` for a family whose rows meet after attention (moe
    routes the whole batch as one group, so an inactive row's output still
    moves the others'): every row attends over its new K/V, as the
    reference computes each row before its gate, and the rows where a given
    ``active`` is False then get their old cache entries back."""
    if active is None:
        return apply_decode(p, cfg, x, k_cache, v_cache, lengths, page_size)
    old_k, old_v = _read_at(k_cache, lengths), _read_at(v_cache, lengths)
    out = apply_decode(p, cfg, x, k_cache, v_cache, lengths, page_size)
    _write_at(k_cache, lengths, old_k, ~active)
    _write_at(v_cache, lengths, old_v, ~active)
    return out


def attend_decode(q, k_cache, v_cache, kv_len, page_size: int) -> torch.Tensor:
    """One query position over a per-slot cache: q (B, Hq, 1, hd), caches
    (B, Hkv, S, hd), ``kv_len`` (B,) valid positions -> (B, Hq, 1, hd) in
    q's dtype. The paged kernel over the cache viewed as pages of
    ``page_size`` on the card, the eager reference on the CPU."""
    if q.is_cuda:
        k_pages, v_pages, table = cache_as_pages(k_cache, v_cache, page_size)
        return paged_attention(q[:, :, 0, :], k_pages, v_pages, table, kv_len)[:, :, None, :]
    return common.attention_decode(q, k_cache.to(q.dtype), v_cache.to(q.dtype), kv_len)


def init_cache(cfg: ModelConfig, n_layers: int, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    shape = (n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
