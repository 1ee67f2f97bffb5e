"""Dense decoder-only LM (smollm / qwen2.5 / internlm2 / qwen1.5-110b), forward only.

Mirrors repro/models/transformer.py. Parameters are an ``nn.Module`` with
one ``Block`` per layer (the reference stacks layers on a leading L axis;
``parity.params_from_jax`` splits that axis onto the blocks). Weights are
stored in ``cfg.param_dtype`` and each layer's weights are cast to
``cfg.compute_dtype`` where the layer runs, as the reference's
``constrain_tree`` does. Logits are f32 over ``cfg.padded_vocab``.

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


class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator, dtype):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.w_gate = attention._param(common.dense_init((d, f), generator, dtype=dtype))
        self.w_up = attention._param(common.dense_init((d, f), generator, dtype=dtype))
        self.w_down = attention._param(common.dense_init(
            (f, d), generator, scale=1.0 / (2 * cfg.n_layers) ** 0.5, dtype=dtype
        ))


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator, dtype):
        super().__init__()
        self.ln1 = attention._param(torch.ones((cfg.d_model,), dtype=dtype))
        self.ln2 = attention._param(torch.ones((cfg.d_model,), dtype=dtype))
        self.attn = attention.Attention(cfg, generator, dtype)
        self.mlp = MLP(cfg, generator, dtype)

    def weights(self, dtype) -> dict:
        """This layer's weights cast to ``dtype``, nested like the reference's tree."""
        cast = lambda m: {n: p.to(dtype) for n, p in m.named_parameters(recurse=False)}
        return {"ln1": self.ln1.to(dtype), "ln2": self.ln2.to(dtype),
                "attn": cast(self.attn), "mlp": cast(self.mlp)}


class Transformer(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        dtype = common.dt(cfg.param_dtype)
        self.embed = attention._param(
            common.embed_init((cfg.padded_vocab, cfg.d_model), generator, dtype)
        )
        self.layers = nn.ModuleList(Block(cfg, generator, dtype) for _ in range(cfg.n_layers))
        self.final_norm = attention._param(torch.ones((cfg.d_model,), dtype=dtype))
        if not cfg.tie_embeddings:
            self.lm_head = attention._param(
                common.dense_init((cfg.d_model, cfg.padded_vocab), generator, dtype=dtype)
            )


def init(cfg: ModelConfig, generator: torch.Generator) -> Transformer:
    """Random init on the CPU, drawn from ``generator``."""
    return Transformer(cfg, generator)


# ---------------------------------------------------------------------------
# blocks


def _embed_in(params: Transformer, cfg: ModelConfig, tokens):
    return params.embed[tokens.long()].to(common.dt(cfg.compute_dtype))


def _head_w(params: Transformer, cfg: ModelConfig):
    return params.embed.T if cfg.tie_embeddings else params.lm_head


def _logits_out(params: Transformer, cfg: ModelConfig, h):
    h = common.rms_norm(h, params.final_norm, cfg.norm_eps)
    return common.matmul_f32(h, _head_w(params, cfg).to(h.dtype))


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
        layer = blk.weights(cdt)
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
        layer = blk.weights(cdt)
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
                page_size: int = 16):
    """One decode step. tokens: (B, 1). Returns (logits, cache').

    ``cache["k"]``/``cache["v"]`` are updated in place; the returned cache
    holds the same tensors and the advanced lengths. ``page_size`` is the
    page the card's decode kernel walks the cache in (the engine passes its
    own); the CPU path ignores it.
    """
    cdt = common.dt(cfg.compute_dtype)
    h = _embed_in(params, cfg, tokens)
    lengths = cache["lengths"]
    for i, blk in enumerate(params.layers):
        layer = blk.weights(cdt)
        x = common.rms_norm(h, layer["ln1"], cfg.norm_eps)
        h = h + attention.apply_decode(layer["attn"], cfg, x, cache["k"][i], cache["v"][i], lengths,
                                       page_size)
        h = _mlp(layer, cfg, h)
    logits = _logits_out(params, cfg, h)
    return logits, {"k": cache["k"], "v": cache["v"], "lengths": lengths + 1}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
    return attention.init_cache(cfg, cfg.n_layers, batch, max_len, dtype, device)
