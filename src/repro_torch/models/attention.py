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
the kernel refuses raises. Meta tensors inside a cost walk take the card's
route (``build.kernel_route``), so the walk prices the card's path. A
training forward takes ``common.AttentionFn`` (``attend``).

Across a mesh (``launch.mesh``) q, k and v leave ``_project_qkv`` under
the reference's constraints: heads over ``MODEL`` where the mesh divides
their count, replicated where it does not (qwen2.5-3b's 2 KV heads on 4
cards). From there to the output projection each rank works on plain
tensors, its own query heads and the KV heads they read
(``_local_heads``): the rotary embedding, the cache write, and the
kernels, whose GQA group is the call's ``hq // hkv``. Passing all KV heads
beside a rank's share of the query heads would pair them wrongly without
an error, so each rank passes exactly the KV heads its queries read. The
cache holds the rank's K/V as the constraint leaves them (its share of
the KV heads, or all of them when they are replicated).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import cache_as_pages, paged_attention
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.mesh import BATCH, MODEL, shard
from repro_torch.models import common


def param_specs(cfg: ModelConfig) -> dict:
    if cfg.sp_activations:
        # sequence-parallel attention (see _project_qkv): weights replicated
        # over MODEL; the seq dim carries the parallelism end to end
        p = {"wq": (None, None), "wk": (None, None), "wv": (None, None), "wo": (None, None)}
        if cfg.qkv_bias:
            p.update({"bq": (None,), "bk": (None,), "bv": (None,)})
        return p
    p = {"wq": (None, MODEL), "wk": (None, MODEL), "wv": (None, MODEL), "wo": (MODEL, None)}
    if cfg.qkv_bias:
        p.update({"bq": (MODEL,), "bk": (MODEL,), "bv": (MODEL,)})
    return p


def cache_specs(cfg: ModelConfig, model_axis: int = 16) -> dict:
    """Sharding for the stacked cache: heads over MODEL when divisible, else seq."""
    if cfg.n_kv_heads % model_axis == 0:
        kv = (None, BATCH, MODEL, None, None)
    else:
        kv = (None, BATCH, None, MODEL, None)
    return {"k": kv, "v": kv, "lengths": (BATCH,)}


def _project_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor):
    b, l, _ = x.shape
    hd = cfg.head_dim
    q = common.matmul_f32(x, p["wq"]).to(x.dtype)
    k = common.matmul_f32(x, p["wk"]).to(x.dtype)
    v = common.matmul_f32(x, p["wv"]).to(x.dtype)
    if cfg.qkv_bias:
        q, k, v = q + p["bq"].to(q.dtype), k + p["bk"].to(k.dtype), v + p["bv"].to(v.dtype)
    q = meshlib.split_last(q, (cfg.n_heads, hd)).transpose(1, 2)
    k = meshlib.split_last(k, (cfg.n_kv_heads, hd)).transpose(1, 2)
    v = meshlib.split_last(v, (cfg.n_kv_heads, hd)).transpose(1, 2)
    if cfg.sp_activations:
        # context/sequence parallelism: q stays seq-sharded (each shard owns
        # its causal rows), k/v are gathered
        q = shard(q, BATCH, None, MODEL, None)
        k = shard(k, BATCH, None, None, None)
        v = shard(v, BATCH, None, None, None)
    else:
        q = shard(q, BATCH, MODEL, None, None)
        k = shard(k, BATCH, MODEL, None, None)
        v = shard(v, BATCH, MODEL, None, None)
    return q, k, v


def _heads(t: torch.Tensor, kv: slice, dim: int = 1) -> torch.Tensor:
    """The KV heads ``kv`` of ``t`` along ``dim``: ``t`` itself for all of them."""
    return t if kv == slice(None) else t.narrow(dim, kv.start, kv.stop - kv.start)


def _local_heads(q, k, v):
    """(q, k, v, kv, wrap, rows) on this rank: its queries and its K/V as
    plain tensors, ``kv`` the slice of its K/V heads that its query heads
    read, ``wrap``, which makes the attention output over its queries a
    DTensor on q's mesh again, placed as q is, and ``rows``, the global
    (batch, sequence) index of its first query. q and k may be sharded on
    their batch (dim 0, over the data axes), and q on its heads (dim 1) or,
    under ``sp_activations``, on its sequence (dim 2, with k and v
    gathered); each rank's gradient of K/V it shares with other ranks'
    queries is a partial sum (``launch.mesh.grad_placements``). Plain
    tensors come back as they are, with every KV head, the identity and
    (0, 0)."""
    if not meshlib.is_dtensor(q):
        return q, k, v, slice(None), lambda o: o, (0, 0)
    for x, dims in ((q, (0, 1, 2)), (k, (0, 1))):
        if any(p.is_shard() and p.dim not in dims for p in x.placements):
            raise ValueError(f"attention across cards takes activations sharded on dims {dims}, "
                             f"not {x.placements}")
    hq, hkv = q.shape[1], k.shape[1]
    ql = q.to_local()
    kl, vl = (x.to_local(grad_placements=meshlib.grad_placements(x, q)) for x in (k, v))
    group = hq // hkv
    q0, n_q, k0 = meshlib.first_index(q, 1), ql.shape[1], meshlib.first_index(k, 1)
    if n_q % group and group % n_q:
        raise ValueError(f"{n_q} local query heads do not group evenly over KV heads of {group}")
    first, n_kv = q0 // group, max(1, n_q // group)
    if first < k0 or first + n_kv > k0 + kl.shape[1]:
        raise ValueError(f"query heads {q0}..{q0 + n_q} read KV heads this rank does not hold")
    kv = slice(first - k0, first - k0 + n_kv)
    if (kv.start, kv.stop) == (0, kl.shape[1]):
        kv = slice(None)  # every local KV head
    wrap = lambda o: meshlib.from_local(o, q.device_mesh, q.placements, tuple(q.shape[:3]) + (o.shape[3],))
    return ql, kl, vl, kv, wrap, (meshlib.first_index(q, 0), meshlib.first_index(q, 2))


def _rope(cfg: ModelConfig, q, k, positions, mrope_positions=None, rows=(0, 0)):
    """RoPE (or M-RoPE) at each tensor's own positions: ``rows`` is the
    global (batch, sequence) index of q's first entry (``_local_heads``);
    k holds the same batch rows and every sequence position."""
    if cfg.rope_theta <= 0:
        return q, k
    b0, s0 = rows
    bq, lq, lk = q.shape[0], q.shape[2], k.shape[2]
    if mrope_positions is not None:
        rope = lambda x, at: common.apply_mrope(x, at, cfg.rope_theta, cfg.mrope_sections)
        return (rope(q, mrope_positions[:, b0:b0 + bq, s0:s0 + lq]),
                rope(k, mrope_positions[:, b0:b0 + bq, :lk]))
    return (common.apply_rope(q, positions[b0:b0 + bq, s0:s0 + lq], cfg.rope_theta),
            common.apply_rope(k, positions[b0:b0 + bq, :lk], cfg.rope_theta))


def _out_proj(p: dict, x_dtype, o: torch.Tensor) -> torch.Tensor:
    b, h, l, hd = o.shape
    o = o.transpose(1, 2).reshape(b, l, h * hd)
    return common.matmul_f32(o, p["wo"]).to(x_dtype)


def attend(q, k, v, *, causal: bool, block_k: int, q_offset: int = 0) -> torch.Tensor:
    """Full-sequence attention, (B, Hq, Lq, hd) over (B, Hkv, Lk, hd) ->
    (B, Hq, Lq, hd): the flash kernel on the card (every key valid, q row 0
    at position ``q_offset``: a rank's first row when the sequence is split
    across cards), the eager online-softmax reference on the CPU. A
    training forward (grad mode on and an input that requires grad) goes
    through ``common.attention_train`` instead, whose forward is the same
    kernel (or the same reference) and whose backward is the reference's,
    masked at the same positions."""
    if common.needs_grad(q, k, v):
        return common.attention_train(q, k, v, causal=causal, q_offset=q_offset, block_k=block_k)
    if build.kernel_route(q):
        return flash_attention(q, k, v, causal=causal, lk_valid=k.shape[2], q_offset=q_offset)
    return common.attention_chunked(q, k, v, causal=causal, q_offset=q_offset, block_k=block_k)


def apply_train(p: dict, cfg: ModelConfig, x, positions, mrope_positions=None, *,
                causal: bool = True, block_k: int = 1024) -> torch.Tensor:
    """Full-sequence attention (forward without cache return)."""
    q, k, v, kv, wrap, rows = _local_heads(*_project_qkv(p, cfg, x))
    q, k = _rope(cfg, q, k, positions, mrope_positions, rows)
    o = attend(q, _heads(k, kv), _heads(v, kv), causal=causal, block_k=block_k, q_offset=rows[1])
    return _out_proj(p, x.dtype, wrap(o))


def apply_prefill(p: dict, cfg: ModelConfig, x, positions, max_len: int, mrope_positions=None,
                  block_k: int = 1024):
    """As apply_train but also returns the (padded-to-max_len) KV for caching
    (across a mesh this rank's K/V, as plain tensors)."""
    q, k, v, kv, wrap, rows = _local_heads(*_project_qkv(p, cfg, x))
    q, k = _rope(cfg, q, k, positions, mrope_positions, rows)
    o = attend(q, _heads(k, kv), _heads(v, kv), causal=True, block_k=block_k, q_offset=rows[1])
    l = x.shape[1]
    if max_len > l:
        k = F.pad(k, (0, 0, 0, max_len - l))
        v = F.pad(v, (0, 0, 0, max_len - l))
    return _out_proj(p, x.dtype, wrap(o)), (k, v)


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
                 active: Optional[torch.Tensor] = None, mrope_positions=None):
    """One-token decode. x: (B, 1, D); caches (B, Hkv, S, hd); lengths (B,).

    Writes the new K/V at position ``lengths`` per sequence IN PLACE into
    ``k_cache``/``v_cache``, except on the rows where a given (B,) bool
    ``active`` is False, whose caches stay as they were; attention sees
    ``lengths + 1`` valid entries. On the card the paged kernel walks the
    cache as pages of ``page_size`` positions (the engine's page size; S
    must be a multiple of it); the CPU path ignores it. Returns the
    attention output (B, 1, D).
    """
    q, k, v, kv, wrap, rows = _local_heads(*_project_qkv(p, cfg, x))
    positions = lengths[:, None].to(torch.int32)  # (B, 1), the cache's rows: this rank's
    q, k = _rope(cfg, q, k, positions, mrope_positions, (0, rows[1]))
    _write_at(k_cache, lengths, k[:, :, 0, :], active)
    _write_at(v_cache, lengths, v[:, :, 0, :], active)
    o = attend_decode(q, k_cache, v_cache, lengths + 1, page_size, kv)
    return _out_proj(p, x.dtype, wrap(o))


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


def attend_decode(q, k_cache, v_cache, kv_len, page_size: int, kv: slice = slice(None)) -> torch.Tensor:
    """One query position over a per-slot cache: q (B, Hq, 1, hd), caches
    (B, Hkv, S, hd), ``kv_len`` (B,) valid positions -> (B, Hq, 1, hd) in
    q's dtype, q's heads reading the cache's KV heads ``kv``. The paged
    kernel over the cache viewed as pages of ``page_size`` on the card (the
    pools' heads ``kv``, a strided view), the eager reference on the CPU."""
    if build.kernel_route(q):
        k_pages, v_pages, table = cache_as_pages(k_cache, v_cache, page_size)
        return paged_attention(q[:, :, 0, :], _heads(k_pages, kv, 0), _heads(v_pages, kv, 0), table,
                               kv_len)[:, :, None, :]
    return common.attention_decode(q, _heads(k_cache, kv).to(q.dtype), _heads(v_cache, kv).to(q.dtype), kv_len)


def init_cache(cfg: ModelConfig, n_layers: int, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    shape = (n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
