"""Whisper-base backbone: encoder-decoder transformer (mirrors
repro/models/whisper.py).

The conv1d mel front end is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, n_audio_frames, D). Sinusoidal positions,
LayerNorm and a GELU MLP, bidirectional encoder self-attention, causal
decoder self-attention and cross-attention. The cross-attention K/V is
computed once per request at prefill and only read by decode.

Parameters are ``common.ParamTree`` nodes under the reference's names,
one node per layer (``parity.params_from_jax`` splits the reference's
stacked ``enc_layers`` and ``dec_layers``). Where the reference's
``constrain_tree`` casts a layer (encode, forward, prefill) every float
leaf is cast to the compute dtype once and held (``ParamTree.tree``); its
decode casts nothing, so decode runs the stored weights, as the reference
does (bf16 activations meet f32 weights, and the cross-attention's q comes
out f32). The norms after the stacks run as stored, and the tied head is
cast once and held.

Attention follows the tensors' device (``attention.attend`` /
``attention.apply_decode``): on the card the encoder and the
cross-attention run the flash kernel non-causal over every key, decoder
self-attention the flash kernel in prefill and the paged kernel in decode;
on the CPU the eager references run.

``features`` is the training trunk (the reference's): the encoder's body
(``_encode``, which the serving ``encode`` wraps under ``torch.no_grad``)
and the decoder layers, each cast as in ``forward`` by casts that carry
the gradient, each decoder layer a checkpoint with remat (the reference
remats its decoder and not its encoder). Its attention is
``common.AttentionFn``: B5 with its softmax stats on the card, non-causal
over the frames in the encoder and the cross-attention, and the
reference's backward in plain PyTorch. The head is the tied embedding, so
its gradient sums the embedding's and the head's.

Across a mesh (``launch.mesh``; the sharded engine) the encoder's and the
prefill's layers are placed at their layer specs where they run (the
reference's ``constrain_tree``); its decode places nothing, its leaves in
the storage layout, as the reference's. Every attention runs on each
rank's own heads (``attention._local_heads``): B5 non-causal in the
encoder, the decoder's self-attention B5 at prefill and B4 at decode, and
its cross-attention B5 over this rank's heads of the cross K/V, which
prefill writes (``_cross_kv``) and the cache holds. The logits come from
the tied embedding, over ``MODEL``. Training across a mesh (``features``)
runs the encoder over frames split over the batch axes, places each
decoder layer at ``dec_layer_specs`` (the reference's ``constrain_tree``),
and the embedding and norms at their compute specs where they are used.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.mesh import BATCH, MODEL, shard
from repro_torch.models import attention, common, transformer
from repro_torch.models.common import ParamTree, frozen

BLOCK_K = 1024  # the reference's k-block for every attention of this model


def _init_ln(d: int, dtype) -> ParamTree:
    return ParamTree(w=torch.ones((d,), dtype=dtype), b=torch.zeros((d,), dtype=dtype))


def _init_mlp(cfg: ModelConfig, g: torch.Generator, dtype) -> ParamTree:
    d, f = cfg.d_model, cfg.d_ff
    return ParamTree(
        w_in=common.dense_init((d, f), g, dtype=dtype),
        b_in=torch.zeros((f,), dtype=dtype),
        w_out=common.dense_init((f, d), g, scale=1.0 / (2 * cfg.n_layers) ** 0.5, dtype=dtype),
        b_out=torch.zeros((d,), dtype=dtype),
    )


def _init_enc_layer(cfg: ModelConfig, g: torch.Generator, dtype) -> ParamTree:
    return ParamTree(ln1=_init_ln(cfg.d_model, dtype), attn=transformer.init_attn(cfg, g, dtype),
                     ln2=_init_ln(cfg.d_model, dtype), mlp=_init_mlp(cfg, g, dtype))


def _init_dec_layer(cfg: ModelConfig, g: torch.Generator, dtype) -> ParamTree:
    return ParamTree(ln1=_init_ln(cfg.d_model, dtype), self_attn=transformer.init_attn(cfg, g, dtype),
                     ln2=_init_ln(cfg.d_model, dtype), cross_attn=transformer.init_attn(cfg, g, dtype),
                     ln3=_init_ln(cfg.d_model, dtype), mlp=_init_mlp(cfg, g, dtype))


class Whisper(nn.Module):
    """The tied embedding, the encoder and decoder stacks, and their norms."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device=None):
        super().__init__()
        dtype = common.dt(cfg.param_dtype)
        d = cfg.d_model
        self.embed = frozen(common.embed_init((cfg.padded_vocab, d), generator, dtype), device)
        # drawn on the CPU and moved one layer at a time
        self.enc_layers = nn.ModuleList(_init_enc_layer(cfg, generator, dtype).to(device)
                                        for _ in range(cfg.n_encoder_layers))
        self.dec_layers = nn.ModuleList(_init_dec_layer(cfg, generator, dtype).to(device)
                                        for _ in range(cfg.n_layers))
        self.enc_norm = _init_ln(d, dtype).to(device)
        self.dec_norm = _init_ln(d, dtype).to(device)


def init(cfg: ModelConfig, generator: torch.Generator, device=None) -> Whisper:
    """Random init drawn on the CPU from ``generator``, placed on ``device``."""
    return Whisper(cfg, generator, device)


# ---------------------------------------------------------------------------
# blocks


def _mlp_specs() -> dict:
    return {"w_in": (None, MODEL), "b_in": (MODEL,), "w_out": (MODEL, None), "b_out": (None,)}


def enc_layer_specs(cfg: ModelConfig) -> dict:
    ln = {"w": (None,), "b": (None,)}
    return {"ln1": ln, "attn": attention.param_specs(cfg), "ln2": ln, "mlp": _mlp_specs()}


def dec_layer_specs(cfg: ModelConfig) -> dict:
    ln = {"w": (None,), "b": (None,)}
    return {"ln1": ln, "self_attn": attention.param_specs(cfg), "ln2": ln,
            "cross_attn": attention.param_specs(cfg), "ln3": ln, "mlp": _mlp_specs()}


def param_specs(cfg: ModelConfig) -> dict:
    ln = {"w": (None,), "b": (None,)}
    return {"embed": (MODEL, None), "enc_layers": transformer.stacked(enc_layer_specs(cfg)),
            "dec_layers": transformer.stacked(dec_layer_specs(cfg)), "enc_norm": ln, "dec_norm": ln}


def cache_specs(cfg: ModelConfig, model_axis: int = 16) -> dict:
    kv = (None, BATCH, MODEL, None, None) if cfg.n_kv_heads % model_axis == 0 else (None, BATCH, None, MODEL, None)
    return {"k": kv, "v": kv, "cross_k": kv, "cross_v": kv, "lengths": (BATCH,)}


def _ln(x, p: dict, eps: float):
    return common.layer_norm(x, p["w"], p["b"], eps)


def _mlp(x, p: dict):
    return common.gelu_mlp(x, p["w_in"], p["b_in"], p["w_out"], p["b_out"])


def _logits_out(params: Whisper, cfg: ModelConfig, h):
    h = _ln(h, params.dec_norm.tree(), cfg.norm_eps)
    return shard(common.matmul_f32(h, common.cast(params, "embed", h.dtype).T), BATCH, None, MODEL)


LN_SPECS = {"w": (None,), "b": (None,)}


def _embed_tokens(params: Whisper, cfg: ModelConfig, tokens, gather: bool = False):
    """The embedding rows of ``tokens``; ``gather`` (the training trunk's)
    places the table at its compute spec where it is used (a pooled
    parameter gathered, ``common.cast``)."""
    emb = common.cast(params, "embed", None, (MODEL, None) if gather else None)
    return meshlib.take_rows(emb, tokens).to(common.dt(cfg.compute_dtype))


def _self_attend(p: dict, cfg: ModelConfig, x, causal: bool):
    """Full-sequence self-attention without a cache (the encoder's, and the
    training decoder's), on this rank's heads across a mesh."""
    q, k, v, kv, wrap, _ = attention._local_heads(*attention._project_qkv(p, cfg, x))
    o = attention.attend(q, attention._heads(k, kv), attention._heads(v, kv), causal=causal, block_k=BLOCK_K)
    return attention._out_proj(p, x.dtype, wrap(o))


@torch.no_grad()
def encode(params: Whisper, cfg: ModelConfig, frames) -> torch.Tensor:
    """frames: (B, T_enc, D) precomputed embeddings (the front end's stub)."""
    return _encode(params, cfg, frames)


def _encode(params: Whisper, cfg: ModelConfig, frames, gather: bool = False) -> torch.Tensor:
    """The encoder, with autograd where a caller has it on (``features``,
    whose ``gather`` places the final norm at its compute spec); across a
    mesh ``frames`` may arrive split over the batch axes."""
    cdt = common.dt(cfg.compute_dtype)
    pe = common.sinusoidal_positions(frames.shape[1], cfg.d_model, frames.device).to(cdt)
    h = meshlib.replicated(frames.to(cdt) + meshlib.like(pe, frames))
    specs = enc_layer_specs(cfg)
    for blk in params.enc_layers:
        layer = blk.tree(cdt, specs)
        h = h + _self_attend(layer["attn"], cfg, _ln(h, layer["ln1"], cfg.norm_eps), causal=False)
        h = h + _mlp(_ln(h, layer["ln2"], cfg.norm_eps), layer["mlp"])
        h = shard(h, BATCH, None, None)
    return _ln(h, params.enc_norm.tree(None, LN_SPECS if gather else None), cfg.norm_eps)


def _heads_of(x, n: int, hd: int):
    """(B, T, n * hd) -> (B, n, T, hd)."""
    return meshlib.split_last(x, (n, hd)).transpose(1, 2)


def _cross_kv(layer: dict, cfg: ModelConfig, enc_out):
    """Cross-attention K/V from the encoder's output: (B, Hkv, T_enc, hd)
    each, a plain ``@`` in the reference (the promoted type); across a mesh
    this rank's heads (and its rows, where the batch is split over the
    data axes), plain, as the cache holds them."""
    p = layer["cross_attn"]
    k = _heads_of(common.matmul_promoted(enc_out, p["wk"]), cfg.n_kv_heads, cfg.head_dim)
    v = _heads_of(common.matmul_promoted(enc_out, p["wv"]), cfg.n_kv_heads, cfg.head_dim)
    return meshlib.local_heads(k, 1), meshlib.local_heads(v, 1)


def _cross_attend(layer: dict, cfg: ModelConfig, x, ck, cv):
    """Cross-attention of ``x`` over ``ck``/``cv`` (across a mesh this rank's
    heads of them, on q's rows): q over heads, and each rank's query heads
    read the cross heads they group over."""
    p = layer["cross_attn"]
    q = shard(_heads_of(common.matmul_promoted(x, p["wq"]), cfg.n_heads, cfg.head_dim), BATCH, MODEL, None, None)
    shape = (q.shape[0], cfg.n_kv_heads) + tuple(ck.shape[2:])
    q, ck, cv, kv, wrap, _ = attention._local_heads(q, meshlib.from_heads(ck, 1, shape, like=q),
                                                    meshlib.from_heads(cv, 1, shape, like=q))
    o = attention.attend(q, attention._heads(ck, kv).to(q.dtype), attention._heads(cv, kv).to(q.dtype),
                         causal=False, block_k=BLOCK_K)
    return attention._out_proj(p, x.dtype, wrap(o))


def _dec_in(params: Whisper, cfg: ModelConfig, tokens, gather: bool = False):
    cdt = common.dt(cfg.compute_dtype)
    h = _embed_tokens(params, cfg, tokens, gather)
    pe = common.sinusoidal_positions(tokens.shape[1], cfg.d_model, tokens.device).to(cdt)
    return shard(h + meshlib.like(pe, h), BATCH, None, None)


def _dec_block(blk, cfg: ModelConfig, h, enc_out):
    """One decoder layer over the whole sequence, cast to the compute dtype
    (the reference's ``forward`` block): causal self-attention, the
    cross-attention over ``enc_out``, the MLP; placed at its layer specs
    under a mesh, as the reference's ``constrain_tree`` places it."""
    layer = blk.tree(common.dt(cfg.compute_dtype), dec_layer_specs(cfg))
    h = h + _self_attend(layer["self_attn"], cfg, _ln(h, layer["ln1"], cfg.norm_eps), causal=True)
    ck, cv = _cross_kv(layer, cfg, enc_out)
    h = h + _cross_attend(layer, cfg, _ln(h, layer["ln2"], cfg.norm_eps), ck, cv)
    return h + _mlp(_ln(h, layer["ln3"], cfg.norm_eps), layer["mlp"])


@torch.no_grad()
def forward(params: Whisper, cfg: ModelConfig, tokens, frames):
    """Teacher-forced decoder over encode(frames) -> logits (B, S, Vp) f32."""
    enc_out = encode(params, cfg, frames)
    h = _dec_in(params, cfg, tokens)
    for blk in params.dec_layers:
        h = _dec_block(blk, cfg, h, enc_out)
    return _logits_out(params, cfg, h)


def features(params: Whisper, cfg: ModelConfig, tokens, frames, *, remat: Optional[bool] = None):
    """Trunk -> (post-norm h (B, S, D), the tied head ``embed``^T (D, Vp) as
    stored), the reference's ``features``; runs with autograd. With
    ``remat`` (default ``cfg.remat``) each decoder layer is a checkpoint
    under ``cfg.remat_policy``; the encoder is not, as in the reference."""
    enc_out = _encode(params, cfg, frames, gather=True)
    h = _dec_in(params, cfg, tokens, gather=True)

    def block(h, enc_out, blk):
        return _dec_block(blk, cfg, h, enc_out)

    block = common.maybe_remat(block, cfg.remat if remat is None else remat, cfg.remat_policy)
    for blk in params.dec_layers:
        h = block(h, enc_out, blk)
    h = _ln(h, params.dec_norm.tree(None, LN_SPECS), cfg.norm_eps)
    return h, common.cast(params, "embed", None, (MODEL, None)).T


# ---------------------------------------------------------------------------
# serving


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None) -> dict:
    cache = attention.init_cache(cfg, cfg.n_layers, batch, max_len, dtype, device)
    cross = (cfg.n_layers, batch, cfg.n_kv_heads, cfg.n_audio_frames, cfg.head_dim)
    cache["cross_k"] = torch.zeros(cross, dtype=dtype, device=device)
    cache["cross_v"] = torch.zeros(cross, dtype=dtype, device=device)
    return cache


@torch.no_grad()
def prefill(params: Whisper, cfg: ModelConfig, tokens, frames, *, max_len: int):
    """Encode the audio and teacher-force the prompt; build the decoder's
    caches, every leaf in bf16 whatever the compute dtype (the reference's).
    Returns (logits, cache)."""
    enc_out = encode(params, cfg, frames)
    cdt = common.dt(cfg.compute_dtype)
    h = _dec_in(params, cfg, tokens)
    b, s = tokens.shape
    positions = common.causal_positions(b, s, h.device)
    kvs = {"k": [], "v": [], "cross_k": [], "cross_v": []}
    specs = dec_layer_specs(cfg)
    for blk in params.dec_layers:
        layer = blk.tree(cdt, specs)
        x = _ln(h, layer["ln1"], cfg.norm_eps)
        a, (k, v) = attention.apply_prefill(layer["self_attn"], cfg, x, positions, max_len,
                                            block_k=BLOCK_K)
        h = h + a
        ck, cv = _cross_kv(layer, cfg, enc_out)
        h = h + _cross_attend(layer, cfg, _ln(h, layer["ln2"], cfg.norm_eps), ck, cv)
        h = shard(h + _mlp(_ln(h, layer["ln3"], cfg.norm_eps), layer["mlp"]), BATCH, None, None)
        for name, t in (("k", k), ("v", v), ("cross_k", ck), ("cross_v", cv)):
            kvs[name].append(t.to(torch.bfloat16))
    cache = {name: torch.stack(ts) for name, ts in kvs.items()}
    cache["lengths"] = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    return _logits_out(params, cfg, h), cache


@torch.no_grad()
def decode_step(params: Whisper, cfg: ModelConfig, cache: dict, tokens, *,
                page_size: int = 16, active: Optional[torch.Tensor] = None):
    """One decode step. tokens: (B, 1). Returns (logits, cache').

    The self-attention K/V is written in place (``attention.apply_decode``,
    ``page_size`` the page the card's paged kernel walks); the cross caches
    are only read. A given (B,) bool ``active`` leaves its False rows'
    K/V and length as they were; the rows never meet after attention, so
    the gate on the write is all they need. The position embedding is the
    row of ``lengths``, clamped to the cache's last position as JAX clamps
    an out-of-range gather (an inactive slot may run past ``max_len``).
    """
    cdt = common.dt(cfg.compute_dtype)
    lengths = cache["lengths"]
    s = cache["k"].shape[3]
    h = _embed_tokens(params, cfg, tokens)
    pe = common.sinusoidal_positions(s, cfg.d_model, tokens.device).to(cdt)
    h = h + meshlib.rows_like(pe[lengths.long().clamp(max=s - 1)], h)[:, None, :]
    for i, blk in enumerate(params.dec_layers):
        layer = blk.tree()  # the reference's decode casts no weight
        x = _ln(h, layer["ln1"], cfg.norm_eps)
        h = h + attention.apply_decode(layer["self_attn"], cfg, x, cache["k"][i], cache["v"][i], lengths,
                                       page_size, active)
        h = h + _cross_attend(layer, cfg, _ln(h, layer["ln2"], cfg.norm_eps), cache["cross_k"][i],
                              cache["cross_v"][i])
        h = h + _mlp(_ln(h, layer["ln3"], cfg.norm_eps), layer["mlp"])
    return _logits_out(params, cfg, h), dict(cache, lengths=common.advance(lengths, active))
