"""Dense decoder-only LM (smollm / qwen2.5 / internlm2 / qwen1.5-110b); also the
backbone of the vlm family (``models/vlm.py``: embeds in, M-RoPE).

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

``features`` is the training trunk (the loss's input): it runs with
autograd, each layer (or each ``remat_every`` layers) under
``common.maybe_remat``, attention through ``common.AttentionFn``; the
serving functions run under ``torch.no_grad()``.

Across a mesh (``launch.mesh``; the sharded engine) the reference's
sharding constraints bind at its sites and nowhere else: each layer's
weights placed at ``layer_specs`` where they run (its ``constrain_tree``;
the placed casts are held), q/k/v over ``MODEL`` (``attention``), the
residual (``_res``, ``_sp_gather``), the embedding gathered at use, the
head, and the logits over ``MODEL``. Each is the identity without an
active mesh, so a path without one runs exactly as before.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.mesh import BATCH, MODEL, shard
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


def layer_specs(cfg: ModelConfig) -> dict:
    """Compute-time (TP) specs for ONE layer (no stacked L axis)."""
    return {
        "ln1": (None,),
        "ln2": (None,),
        "attn": attention.param_specs(cfg),
        "mlp": {"w_gate": (None, MODEL), "w_up": (None, MODEL), "w_down": (MODEL, None)},
    }


def stacked(specs: dict) -> dict:
    """A layer's specs with a leading ``None`` on every leaf: the reference's
    layers are stacked on a leading L axis."""
    return {k: stacked(v) if isinstance(v, dict) else (None,) + tuple(v) for k, v in specs.items()}


def param_specs(cfg: ModelConfig) -> dict:
    """Compute-time (TP) partition specs, matching the reference's ``init``
    tree (layer leaves with a leading ``None`` for the stacked L axis)."""
    specs = {"embed": (MODEL, None), "layers": stacked(layer_specs(cfg)), "final_norm": (None,)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, MODEL)
    return specs


def cache_specs(cfg: ModelConfig, model_axis: int = 16) -> dict:
    return attention.cache_specs(cfg, model_axis)


# ---------------------------------------------------------------------------
# blocks


def _res(cfg: ModelConfig, h):
    # residual-stream constraint; sp_activations shards the seq dim over the
    # TP axis (Megatron sequence parallelism), a training memory feature
    return shard(h, BATCH, MODEL if cfg.sp_activations else None, None)


def _sp_gather(cfg: ModelConfig, x):
    # the Megatron-SP boundary: gather the seq-sharded residual before the
    # TP-sharded products
    if cfg.sp_activations:
        return shard(x, BATCH, None, None)
    return x


def _embed_in(params: Transformer, cfg: ModelConfig, tokens=None, embeds=None):
    """The residual stream's input in the compute dtype: the embedding rows
    of ``tokens`` (the table gathered at use, its rows over ``MODEL``), or
    given ``embeds`` (B, L, D) as they are."""
    if embeds is None:
        w = common.cast(params, "embed", None, (MODEL, None))  # gather-at-use
        embeds = meshlib.take_rows(w, tokens)
    return _res(cfg, embeds.to(common.dt(cfg.compute_dtype)))


def _head_w(params: Transformer, cfg: ModelConfig, dtype):
    """The output head as ``dtype``, cast once and held (``common.cast``)."""
    if cfg.tie_embeddings:
        return common.cast(params, "embed", dtype, (MODEL, None)).T
    return common.cast(params, "lm_head", dtype, (None, MODEL))


def _head_param(params: Transformer, cfg: ModelConfig):
    """The output head as stored (the tied embedding's transpose for a tied
    config), uncast: the fused CE casts it per chunk, as the reference's.
    Under a mesh it is gathered at use to its compute layout."""
    if cfg.tie_embeddings:
        return common.cast(params, "embed", None, (MODEL, None)).T
    return common.cast(params, "lm_head", None, (None, MODEL))


def _logits_out(params: Transformer, cfg: ModelConfig, h):
    h = common.rms_norm(h, common.cast(params, "final_norm", None, (None,)), cfg.norm_eps)
    logits = common.matmul_f32(h, _head_w(params, cfg, h.dtype))
    return shard(logits, BATCH, None, MODEL)


def _mlp(layer: dict, cfg: ModelConfig, h):
    x = _sp_gather(cfg, common.rms_norm(h, layer["ln2"], cfg.norm_eps))
    m = layer["mlp"]
    return h + common.swiglu(x, m["w_gate"], m["w_up"], m["w_down"])


@torch.no_grad()
def forward(params: Transformer, cfg: ModelConfig, tokens=None, embeds=None, mrope_positions=None,
            *, block_k: Optional[int] = None):
    """Full-sequence forward -> logits (B, S, Vp) f32, from ``tokens`` or
    from ``embeds`` (with (3, B, S) ``mrope_positions`` for M-RoPE)."""
    block_k = block_k or cfg.attn_block_k
    cdt = common.dt(cfg.compute_dtype)
    h = _embed_in(params, cfg, tokens, embeds)
    b, l, _ = h.shape
    positions = common.causal_positions(b, l, h.device)
    specs = layer_specs(cfg)
    for blk in params.layers:
        layer = blk.tree(cdt, specs)
        x = common.rms_norm(h, layer["ln1"], cfg.norm_eps)
        h = h + attention.apply_train(layer["attn"], cfg, x, positions, mrope_positions,
                                      block_k=block_k)
        h = _res(cfg, _mlp(layer, cfg, h))
    return _logits_out(params, cfg, h)


def _block_train(cfg: ModelConfig, h, blk: nn.Module, positions, mrope_positions, block_k: int):
    """One layer of the training trunk (the reference's ``_block_train``):
    the layer's float leaves cast to the compute dtype where it runs (a
    cast that carries the gradient), then attention and the MLP."""
    layer = blk.tree(common.dt(cfg.compute_dtype), layer_specs(cfg))
    x = common.rms_norm(h, layer["ln1"], cfg.norm_eps)
    h = h + attention.apply_train(layer["attn"], cfg, x, positions, mrope_positions,
                                  block_k=block_k)
    return _res(cfg, _mlp(layer, cfg, h))


def features(params: Transformer, cfg: ModelConfig, tokens=None, embeds=None, mrope_positions=None,
             *, remat: Optional[bool] = None, block_k: Optional[int] = None):
    """Trunk -> (post-final-norm h (B, S, D), head weight (D, Vp) as stored).

    The loss pairs this with ``common.fused_ce_loss``, so the full logits
    are never materialized. ``remat`` (default ``cfg.remat``) checkpoints
    every ``cfg.remat_every`` layers as one block under
    ``cfg.remat_policy``. Runs with autograd; ``forward`` is the serving
    form.
    """
    block_k = block_k or cfg.attn_block_k
    h = _embed_in(params, cfg, tokens, embeds)
    b, l, _ = h.shape
    positions = common.causal_positions(b, l, h.device)
    use_remat = cfg.remat if remat is None else remat
    k = max(cfg.remat_every, 1)
    n = len(params.layers)
    if n % k:
        raise ValueError(f"remat_every {k} does not divide {n} layers")

    def block(h, blks):
        # k layers per checkpoint: the saved residuals scale as 1/k
        for blk in blks:
            h = _block_train(cfg, h, blk, positions, mrope_positions, block_k)
        return h

    block = common.maybe_remat(block, use_remat, cfg.remat_policy)
    for i in range(0, n, k):
        h = block(h, params.layers[i:i + k])
    h = common.rms_norm(h, common.cast(params, "final_norm", None, (None,)), cfg.norm_eps)
    return h, _head_param(params, cfg)


# ---------------------------------------------------------------------------
# serving


@torch.no_grad()
def prefill(params: Transformer, cfg: ModelConfig, tokens=None, embeds=None, mrope_positions=None,
            *, max_len: int, block_k: Optional[int] = None):
    """Forward + KV cache construction. Returns (logits, cache)."""
    block_k = block_k or cfg.attn_block_k
    cdt = common.dt(cfg.compute_dtype)
    h = _embed_in(params, cfg, tokens, embeds)
    b, l, _ = h.shape
    positions = common.causal_positions(b, l, h.device)
    ks, vs = [], []
    specs = layer_specs(cfg)
    for blk in params.layers:
        layer = blk.tree(cdt, specs)
        x = common.rms_norm(h, layer["ln1"], cfg.norm_eps)
        a, (k, v) = attention.apply_prefill(layer["attn"], cfg, x, positions, max_len,
                                            mrope_positions, block_k=block_k)
        h = _res(cfg, _mlp(layer, cfg, h + a))
        ks.append(k.to(torch.bfloat16))
        vs.append(v.to(torch.bfloat16))
    cache = {
        "k": torch.stack(ks),
        "v": torch.stack(vs),
        "lengths": torch.full((b,), l, dtype=torch.int32, device=h.device),
    }
    return _logits_out(params, cfg, h), cache


@torch.no_grad()
def decode_step(params: Transformer, cfg: ModelConfig, cache: dict, tokens, mrope_positions=None, *,
                page_size: int = 16, active: Optional[torch.Tensor] = None):
    """One decode step. tokens: (B, 1). Returns (logits, cache').

    ``cache["k"]``/``cache["v"]`` are updated in place; the returned cache
    holds the same tensors and the advanced lengths. Given (3, B, 1)
    ``mrope_positions``, the new token's q and k take M-RoPE at them, else
    RoPE at ``lengths``. A given (B,) bool
    ``active`` gates the step per row, as the reference's chunk column
    gates every cache leaf: a row where it is False keeps its K/V and its
    length. ``page_size`` is the page the card's decode kernel walks the
    cache in (the engine passes its own); the CPU path ignores it.
    """
    cdt = common.dt(cfg.compute_dtype)
    h = _embed_in(params, cfg, tokens)
    lengths = cache["lengths"]
    specs = layer_specs(cfg)
    for i, blk in enumerate(params.layers):
        layer = blk.tree(cdt, specs)
        x = common.rms_norm(h, layer["ln1"], cfg.norm_eps)
        h = h + attention.apply_decode(layer["attn"], cfg, x, cache["k"][i], cache["v"][i], lengths,
                                       page_size, active, mrope_positions)
        h = _mlp(layer, cfg, h)
    logits = _logits_out(params, cfg, h)
    return logits, {"k": cache["k"], "v": cache["v"], "lengths": common.advance(lengths, active)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
    return attention.init_cache(cfg, cfg.n_layers, batch, max_len, dtype, device)
