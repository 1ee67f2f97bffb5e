"""Dense decoder-only LM (smollm / qwen2.5 / internlm2 / qwen1.5-110b), forward only.

Mirrors repro/models/transformer.py. Parameters are ``common.ParamTree``
nodes under the reference's names, one node per layer (the reference
stacks layers on a leading L axis; ``parity.params_from_jax`` splits that
axis onto the layers). Weights are stored in ``cfg.param_dtype`` and each
layer's weights are cast to ``cfg.compute_dtype`` where the layer runs, as
the reference's ``constrain_tree`` does. Logits are f32 over
``cfg.padded_vocab``.

PyTorch runs eagerly, so there is no counterpart of the reference's
``lax.scan`` or ``jax.jit``: layers are a Python loop, and ``decode_step``
writes the new K/V into the cache tensors in place.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common
from repro_torch.models.common import ParamTree, frozen


def init_attn(cfg: ModelConfig, g: torch.Generator, dtype) -> ParamTree:
    """One layer's attention projections (and zero biases with ``qkv_bias``)."""
    d, hd = cfg.d_model, cfg.head_dim
    q_dim, kv_dim = cfg.n_heads * hd, cfg.n_kv_heads * hd
    out_scale = 1.0 / (2 * cfg.n_layers) ** 0.5
    attn = dict(
        wq=common.dense_init((d, q_dim), g, dtype=dtype),
        wk=common.dense_init((d, kv_dim), g, dtype=dtype),
        wv=common.dense_init((d, kv_dim), g, dtype=dtype),
        wo=common.dense_init((q_dim, d), g, scale=out_scale, dtype=dtype),
    )
    if cfg.qkv_bias:
        attn.update(bq=torch.zeros((q_dim,), dtype=dtype), bk=torch.zeros((kv_dim,), dtype=dtype),
                    bv=torch.zeros((kv_dim,), dtype=dtype))
    return ParamTree(**attn)


def _init_layer(cfg: ModelConfig, g: torch.Generator, dtype) -> ParamTree:
    d, f = cfg.d_model, cfg.d_ff
    out_scale = 1.0 / (2 * cfg.n_layers) ** 0.5
    return ParamTree(
        ln1=torch.ones((d,), dtype=dtype),
        ln2=torch.ones((d,), dtype=dtype),
        attn=init_attn(cfg, g, dtype),  # drawn before the MLP
        mlp=ParamTree(
            w_gate=common.dense_init((d, f), g, dtype=dtype),
            w_up=common.dense_init((d, f), g, dtype=dtype),
            w_down=common.dense_init((f, d), g, scale=out_scale, dtype=dtype),
        ),
    )


class Transformer(nn.Module):
    """Embedding, layers and head; ``init_layer`` draws one layer (the moe
    family passes its own)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device=None,
                 init_layer=_init_layer):
        super().__init__()
        dtype = common.dt(cfg.param_dtype)
        d, vp = cfg.d_model, cfg.padded_vocab
        self.embed = frozen(common.embed_init((vp, d), generator, dtype), device)
        # drawn on the CPU and moved one layer at a time: host memory holds one layer
        self.layers = nn.ModuleList(init_layer(cfg, generator, dtype).to(device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = frozen(torch.ones((d,), dtype=dtype), device)
        if not cfg.tie_embeddings:
            self.lm_head = frozen(common.dense_init((d, vp), generator, dtype=dtype), device)


def init(cfg: ModelConfig, generator: torch.Generator, device=None) -> Transformer:
    """Random init drawn on the CPU from ``generator``, placed on ``device``."""
    return Transformer(cfg, generator, device)


# ---------------------------------------------------------------------------
# blocks


def _embed_in(params: Transformer, cfg: ModelConfig, tokens):
    return params.embed[tokens.long()].to(common.dt(cfg.compute_dtype))


def _head_w(params: Transformer, cfg: ModelConfig, dtype):
    """The output head as ``dtype``, cast once and held (``common.cast``)."""
    if cfg.tie_embeddings:
        return common.cast(params, "embed", dtype).T
    return common.cast(params, "lm_head", dtype)


def _logits_out(params: Transformer, cfg: ModelConfig, h):
    h = common.rms_norm(h, params.final_norm, cfg.norm_eps)
    return common.matmul_f32(h, _head_w(params, cfg, h.dtype))


def _mlp(layer: dict, cfg: ModelConfig, h):
    x = common.rms_norm(h, layer["ln2"], cfg.norm_eps)
    m = layer["mlp"]
    return h + common.swiglu(x, m["w_gate"], m["w_up"], m["w_down"])


@torch.no_grad()
def forward(params: Transformer, cfg: ModelConfig, tokens, *, block_k: Optional[int] = None):
    """Full-sequence forward -> logits (B, S, Vp) f32."""
    block_k = block_k or cfg.attn_block_k
    cdt = common.dt(cfg.compute_dtype)
    h = _embed_in(params, cfg, tokens)
    b, l, _ = h.shape
    positions = common.causal_positions(b, l, h.device)
    for blk in params.layers:
        layer = blk.tree(cdt)
        x = common.rms_norm(h, layer["ln1"], cfg.norm_eps)
        h = h + attention.apply_train(layer["attn"], cfg, x, positions, block_k=block_k)
        h = _mlp(layer, cfg, h)
    return _logits_out(params, cfg, h)


# ---------------------------------------------------------------------------
# serving


@torch.no_grad()
def prefill(params: Transformer, cfg: ModelConfig, tokens, *, max_len: int,
            block_k: Optional[int] = None):
    """Forward + KV cache construction. Returns (logits, cache)."""
    block_k = block_k or cfg.attn_block_k
    cdt = common.dt(cfg.compute_dtype)
    h = _embed_in(params, cfg, tokens)
    b, l, _ = h.shape
    positions = common.causal_positions(b, l, h.device)
    ks, vs = [], []
    for blk in params.layers:
        layer = blk.tree(cdt)
        x = common.rms_norm(h, layer["ln1"], cfg.norm_eps)
        a, (k, v) = attention.apply_prefill(layer["attn"], cfg, x, positions, max_len,
                                            block_k=block_k)
        h = _mlp(layer, cfg, h + a)
        ks.append(k.to(torch.bfloat16))
        vs.append(v.to(torch.bfloat16))
    cache = {
        "k": torch.stack(ks),
        "v": torch.stack(vs),
        "lengths": torch.full((b,), l, dtype=torch.int32, device=h.device),
    }
    return _logits_out(params, cfg, h), cache


@torch.no_grad()
def decode_step(params: Transformer, cfg: ModelConfig, cache: dict, tokens, *,
                page_size: int = 16, active: Optional[torch.Tensor] = None):
    """One decode step. tokens: (B, 1). Returns (logits, cache').

    ``cache["k"]``/``cache["v"]`` are updated in place; the returned cache
    holds the same tensors and the advanced lengths. A given (B,) bool
    ``active`` gates the step per row, as the reference's chunk column
    gates every cache leaf: a row where it is False keeps its K/V and its
    length. ``page_size`` is the page the card's decode kernel walks the
    cache in (the engine passes its own); the CPU path ignores it.
    """
    cdt = common.dt(cfg.compute_dtype)
    h = _embed_in(params, cfg, tokens)
    lengths = cache["lengths"]
    for i, blk in enumerate(params.layers):
        layer = blk.tree(cdt)
        x = common.rms_norm(h, layer["ln1"], cfg.norm_eps)
        h = h + attention.apply_decode(layer["attn"], cfg, x, cache["k"][i], cache["v"][i], lengths,
                                       page_size, active)
        h = _mlp(layer, cfg, h)
    logits = _logits_out(params, cfg, h)
    return logits, {"k": cache["k"], "v": cache["v"], "lengths": common.advance(lengths, active)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
    return attention.init_cache(cfg, cfg.n_layers, batch, max_len, dtype, device)
