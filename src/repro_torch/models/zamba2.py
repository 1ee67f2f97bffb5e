"""Zamba2 hybrid: a Mamba2 backbone and one SHARED attention block applied
after every ``shared_attn_every`` Mamba2 layers.

Mirrors repro/models/zamba2.py. The shared block is one parameter set
reused at every application depth; its input is concat(hidden, original
embedding) (2d), projected through attention and a 2d -> d_ff MLP back
into the residual stream. Each application keeps its own KV cache
(n_apps, B, Hkv, S, hd) bf16, beside the per-layer Mamba2 conv tails and
SSM states.

Numerics mirror the reference's, its asymmetry included: ``forward`` casts
the shared block's weights to ``cfg.compute_dtype`` (``shared_block_train``)
but ``prefill`` and ``decode_step`` use them as stored
(``shared_block_prefill``/``_decode``), so at full width bf16 activations
meet f32 weights and q, k, v come out f32. Attention follows the tensors'
device as in ``models/attention.py``: on the card the flash kernel runs
the f32 prefill and the paged kernel the decode (an f32 query over the
bf16 cache viewed as pages), once per application; on the CPU the eager
reference attention. ``decode_step`` updates the cache tensors in place.

``features`` is the training trunk (the reference's): the shared block
cast as in ``forward``, remat nested as the reference nests it, each group
of Mamba2 layers and its shared block one checkpoint around a checkpoint
per layer. In the backward a group's recompute runs each of its layers'
forwards again, and each layer's own checkpoint a third time: with remat,
B7 runs three times a grouped layer and twice a tail layer, B5 twice an
application (``api.train_kernel_launches``).

Across a mesh (``launch.mesh``; the sharded engine) each Mamba2 layer is
placed at ``mamba2.block_specs`` where it runs (the reference's
``constrain_tree`` inside its ``apply``) and runs B7 on each rank's own
heads (``mamba2.apply``). The shared block stays as stored, uncast, as the
reference's serving leaves it; its q and k go over heads at the
reference's site, v on k's heads, and each rank runs B5/B4 on its own
heads (``attention._local_heads``), its KV cache holding only those.
Training across a mesh (``features``) places each Mamba2 layer at
``block_specs`` and the cast shared block at ``shared_specs`` where they
run, the embedding, final norm and head at their compute specs, and runs
on each rank's batch rows; the shared block's gradient sums its
applications, then the data-parallel ranks.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.mesh import BATCH, MODEL, shard
from repro_torch.models import attention, common, mamba2
from repro_torch.models.common import ParamTree, frozen, matmul_f32, matmul_promoted, rms_norm


def n_attn_apps(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.shared_attn_every


# ---------------------------------------------------------------------------
# init


def _init_shared(cfg: ModelConfig, g: torch.Generator, dtype) -> ParamTree:
    d = cfg.d_model
    u = 2 * d  # concat(hidden, embedding)
    q_dim, kv_dim = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    return ParamTree(
        ln1=torch.ones((u,), dtype=dtype),
        wq=common.dense_init((u, q_dim), g, dtype=dtype),
        wk=common.dense_init((u, kv_dim), g, dtype=dtype),
        wv=common.dense_init((u, kv_dim), g, dtype=dtype),
        wo=common.dense_init((q_dim, d), g, scale=0.1, dtype=dtype),
        ln2=torch.ones((u,), dtype=dtype),
        w_gate=common.dense_init((u, cfg.d_ff), g, dtype=dtype),
        w_up=common.dense_init((u, cfg.d_ff), g, dtype=dtype),
        w_down=common.dense_init((cfg.d_ff, d), g, scale=0.1, dtype=dtype),
    )


class Zamba2(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device=None):
        super().__init__()
        dtype = common.dt(cfg.param_dtype)
        d, vp = cfg.d_model, cfg.padded_vocab
        self.embed = frozen(common.embed_init((vp, d), generator, dtype), device)
        # drawn on the CPU and moved one layer at a time: host memory holds one layer
        self.layers = nn.ModuleList(mamba2.init_block(cfg, generator, dtype).to(device)
                                    for _ in range(cfg.n_layers))
        self.shared = _init_shared(cfg, generator, dtype).to(device)
        self.final_norm = frozen(torch.ones((d,), dtype=dtype), device)
        self.lm_head = frozen(common.dense_init((d, vp), generator, dtype=dtype), device)


def init(cfg: ModelConfig, generator: torch.Generator, device=None) -> Zamba2:
    """Random init drawn on the CPU from ``generator``, placed on ``device``."""
    return Zamba2(cfg, generator, device)


# ---------------------------------------------------------------------------
# shared attention block


def param_specs(cfg: ModelConfig) -> dict:
    from repro_torch.models.transformer import stacked

    return {
        "embed": (MODEL, None),
        "layers": stacked(mamba2.block_specs(cfg)),
        "shared": {"ln1": (None,), "wq": (None, MODEL), "wk": (None, MODEL), "wv": (None, MODEL),
                   "wo": (MODEL, None), "ln2": (None,), "w_gate": (None, MODEL), "w_up": (None, MODEL),
                   "w_down": (MODEL, None)},
        "final_norm": (None,),
        "lm_head": (None, MODEL),
    }


def shared_specs(cfg: ModelConfig) -> dict:
    return param_specs(cfg)["shared"]


def cache_specs(cfg: ModelConfig, model_axis: int = 16) -> dict:
    kv = (None, BATCH, MODEL, None, None) if cfg.n_kv_heads % model_axis == 0 else (None, BATCH, None, MODEL, None)
    return {"k": kv, "v": kv, "conv": (None, BATCH, None, None), "ssm": (None, BATCH, MODEL, None, None),
            "lengths": (BATCH,)}


def _shared_qkv(sh: dict, cfg: ModelConfig, u, positions, every_row: bool = True):
    """``x @ W`` without a preferred type: bf16 x f32 gives f32, as in JAX.
    Returns ``attention._local_heads``'s (q, k, v, kv, wrap), RoPE applied:
    across a mesh this rank's heads as plain tensors (q and k over heads,
    the reference's constraint, v on k's), else every head. ``positions``
    hold every row of the batch (``every_row``), or this rank's rows (a
    decode's, from the cache's lengths)."""
    hd = cfg.head_dim
    un = rms_norm(u, sh["ln1"], cfg.norm_eps)

    def heads(w, n):
        x = meshlib.split_last(matmul_promoted(un, w), (n, hd)).transpose(1, 2)
        return shard(x, BATCH, MODEL, None, None)

    q, k, v, kv, wrap, rows = attention._local_heads(heads(sh["wq"], cfg.n_heads), heads(sh["wk"], cfg.n_kv_heads),
                                                     heads(sh["wv"], cfg.n_kv_heads))
    q, k = attention._rope(cfg, q, k, positions, rows=rows if every_row else (0, rows[1]))
    return q, k, v, kv, wrap


def _shared_out(sh: dict, cfg: ModelConfig, h, emb0, o):
    """Attention output projection into the residual stream, then the MLP
    on concat(h, emb0)."""
    b, hh, t, hd = o.shape
    h = h + matmul_promoted(o.transpose(1, 2).reshape(b, t, hh * hd), sh["wo"]).to(h.dtype)
    un2 = rms_norm(torch.cat([h, emb0], dim=-1), sh["ln2"], cfg.norm_eps)
    return h + common.swiglu(un2, sh["w_gate"], sh["w_up"], sh["w_down"])


def shared_block(sh: dict, cfg: ModelConfig, h, emb0, positions):
    """Full-sequence application without a cache; returns (h', k, v), k and v
    this rank's heads across a mesh."""
    q, k, v, kv, wrap = _shared_qkv(sh, cfg, torch.cat([h, emb0], dim=-1), positions)
    o = attention.attend(q, attention._heads(k, kv), attention._heads(v, kv), causal=True, block_k=1024)
    return _shared_out(sh, cfg, h, emb0, wrap(o)), k, v


def shared_block_decode(sh: dict, cfg: ModelConfig, h, emb0, k_cache, v_cache, lengths,
                        page_size: int, active: Optional[torch.Tensor] = None):
    """h, emb0: (B, 1, D); caches (B, Hkv, S, hd), written IN PLACE at
    ``lengths`` (a position past the end is dropped, as JAX drops it, and
    so is a row where a given (B,) bool ``active`` is False)."""
    positions = lengths[:, None].to(torch.int32)
    q, k, v, kv, wrap = _shared_qkv(sh, cfg, torch.cat([h, emb0], dim=-1), positions, every_row=False)
    attention._write_at(k_cache, lengths, k[:, :, 0, :], active)
    attention._write_at(v_cache, lengths, v[:, :, 0, :], active)
    o = attention.attend_decode(q, k_cache, v_cache, lengths + 1, page_size, kv)
    return _shared_out(sh, cfg, h, emb0, wrap(o))


# ---------------------------------------------------------------------------
# full model


def _embed(params: Zamba2, cfg: ModelConfig, tokens, gather: bool = False):
    """The embedding rows of ``tokens``; ``gather`` (the training trunk's)
    places the table at its compute spec where it is used (a pooled
    parameter gathered, ``common.cast``)."""
    emb = common.cast(params, "embed", None, (MODEL, None) if gather else None)
    h = meshlib.take_rows(emb, tokens).to(common.dt(cfg.compute_dtype))
    return shard(h, BATCH, None, None)


def _logits(params: Zamba2, cfg: ModelConfig, h):
    h = rms_norm(h, common.cast(params, "final_norm", None), cfg.norm_eps)
    return shard(matmul_f32(h, common.cast(params, "lm_head", h.dtype)), BATCH, None, MODEL)


def _split_groups(cfg: ModelConfig, seq):
    """Per-layer sequence -> (G groups of ``shared_attn_every``, the tail)."""
    k = cfg.shared_attn_every
    g = cfg.n_layers // k
    return [seq[i * k:(i + 1) * k] for i in range(g)], seq[g * k:]


@torch.no_grad()
def forward(params: Zamba2, cfg: ModelConfig, tokens):
    """Full-sequence forward -> logits (B, T, Vp) f32 (the shared block cast
    to the compute dtype, as the reference's ``shared_block_train``)."""
    h = _embed(params, cfg, tokens)
    emb0 = h
    b, t, _ = h.shape
    positions = common.causal_positions(b, t, h.device)
    cdt = common.dt(cfg.compute_dtype)
    sh = params.shared.tree(cdt)
    groups, tail = _split_groups(cfg, list(params.layers))
    for grp in groups:
        for blk in grp:
            h = h + mamba2.apply(blk.tree(cdt), cfg, h)[0]
        h = shared_block(sh, cfg, h, emb0, positions)[0]
    for blk in tail:
        h = h + mamba2.apply(blk.tree(cdt), cfg, h)[0]
    return _logits(params, cfg, h)


def features(params: Zamba2, cfg: ModelConfig, tokens, *, remat: Optional[bool] = None):
    """Trunk -> (post-final-norm h (B, T, D), ``lm_head`` as stored), the
    reference's ``features``; runs with autograd (``forward`` is the
    serving form). Every float leaf, the shared block's included, is cast
    to the compute dtype where it runs (``shared_block_train``), by casts
    that carry the gradient. With ``remat`` (default ``cfg.remat``) each
    Mamba2 layer is a checkpoint under ``cfg.remat_policy``, and so is each
    group of ``shared_attn_every`` of them with its shared block."""
    h = _embed(params, cfg, tokens, gather=True)
    b, t, _ = h.shape
    positions = common.causal_positions(b, t, h.device)
    cdt = common.dt(cfg.compute_dtype)
    use_remat = cfg.remat if remat is None else remat
    specs = mamba2.block_specs(cfg)

    def mamba_layer(h, blk):
        return shard(h + mamba2.apply(blk.tree(cdt, specs), cfg, h)[0], BATCH, None, None)

    mamba_layer = common.maybe_remat(mamba_layer, use_remat, cfg.remat_policy)

    def group(h, emb0, blks):
        for blk in blks:
            h = mamba_layer(h, blk)
        return shard(shared_block(params.shared.tree(cdt, shared_specs(cfg)), cfg, h, emb0, positions)[0],
                     BATCH, None, None)

    group = common.maybe_remat(group, use_remat, cfg.remat_policy)
    groups, tail = _split_groups(cfg, list(params.layers))
    emb0 = h
    for blks in groups:
        h = group(h, emb0, blks)
    for blk in tail:
        h = mamba_layer(h, blk)
    h = rms_norm(h, common.cast(params, "final_norm", None, (None,)), cfg.norm_eps)
    return h, common.cast(params, "lm_head", None, (None, MODEL))


@torch.no_grad()
def prefill(params: Zamba2, cfg: ModelConfig, tokens, *, max_len: int):
    """Forward + cache construction. Returns (logits, cache)."""
    h = _embed(params, cfg, tokens)
    emb0 = h
    b, t, _ = h.shape
    positions = common.causal_positions(b, t, h.device)
    sh = params.shared.tree()  # as stored: the reference's prefill does not cast it
    cdt = common.dt(cfg.compute_dtype)
    specs = mamba2.block_specs(cfg)
    states, ks, vs = [], [], []

    def mamba_layer(h, blk):
        m, st = mamba2.apply(blk.tree(cdt, specs), cfg, h)
        states.append(st)
        return shard(h + m, BATCH, None, None)

    groups, tail = _split_groups(cfg, list(params.layers))
    for grp in groups:
        for blk in grp:
            h = mamba_layer(h, blk)
        h, k, v = shared_block(sh, cfg, h, emb0, positions)
        h = shard(h, BATCH, None, None)
        ks.append(F.pad(k, (0, 0, 0, max(0, max_len - t))).to(torch.bfloat16))
        vs.append(F.pad(v, (0, 0, 0, max(0, max_len - t))).to(torch.bfloat16))
    for blk in tail:
        h = mamba_layer(h, blk)
    cache = {
        "k": torch.stack(ks),
        "v": torch.stack(vs),
        "conv": torch.stack([s["conv"] for s in states]),
        "ssm": torch.stack([s["ssm"] for s in states]),
        "lengths": torch.full((b,), t, dtype=torch.int32, device=h.device),
    }
    return _logits(params, cfg, h), cache


@torch.no_grad()
def decode_step(params: Zamba2, cfg: ModelConfig, cache: dict, tokens, *, page_size: int = 16,
                active: Optional[torch.Tensor] = None):
    """One decode step. tokens: (B, 1). Returns (logits, cache').

    Every cache tensor is updated in place; the returned cache holds the
    same tensors and the advanced lengths. A given (B,) bool ``active``
    gates the step per row, as the reference's chunk column gates every
    cache leaf: a row where it is False keeps its K/V, conv tails, SSM
    states and length. On the card the shared block's decode attention
    walks its cache as pages of ``page_size`` positions (the engine's page
    size; max_len must be a multiple of it).
    """
    h = _embed(params, cfg, tokens)
    emb0 = h
    lengths = cache["lengths"]
    cdt = common.dt(cfg.compute_dtype)
    sh = params.shared.tree()  # as stored: the reference's decode does not cast it
    specs = mamba2.block_specs(cfg)

    def mamba_layer(h, i):
        state = {"conv": cache["conv"][i], "ssm": cache["ssm"][i]}
        return h + mamba2.apply(params.layers[i].tree(cdt, specs), cfg, h, state, active)[0]

    groups, tail = _split_groups(cfg, list(range(cfg.n_layers)))
    for app, grp in enumerate(groups):
        for i in grp:
            h = mamba_layer(h, i)
        h = shared_block_decode(sh, cfg, h, emb0, cache["k"][app], cache["v"][app], lengths,
                                page_size, active)
    for i in tail:
        h = mamba_layer(h, i)
    return _logits(params, cfg, h), {**cache, "lengths": common.advance(lengths, active)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
    ms = mamba2.init_state(cfg, batch, device)
    kv = (n_attn_apps(cfg), batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device),
        "conv": torch.zeros((cfg.n_layers,) + tuple(ms["conv"].shape), dtype=torch.float32,
                            device=device),
        "ssm": torch.zeros((cfg.n_layers,) + tuple(ms["ssm"].shape), dtype=torch.float32,
                           device=device),
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
