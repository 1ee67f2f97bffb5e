"""RWKV6 "Finch" (attention-free, data-dependent decay).

Mirrors repro/models/rwkv6.py. Time-mix: token shift with LoRA-modulated
per-channel interpolation, then the WKV6 recurrence per head of
``cfg.ssm_head_dim``; channel-mix: token shift and a squared-ReLU FFN
with a receptance gate. The recurrence is ``kernels.rwkv6_scan``'s
``wkv6_chunked`` on the log-decay ``lw = -exp(w0 + xw w1 w2)``: its plain
version on the CPU, the hand-written kernel on the card, once per layer
per prefill and per decode step. A training forward (``features``) takes
``wkv6_train`` instead: the same kernel writing its chunk-entry states,
and the chunked VJP in plain PyTorch for the backward.

Parameters are ``common.ParamTree`` nodes under the reference's names (its
stacked ``layers`` leaves split onto one node per layer, as
``parity.params_from_jax`` does). Each layer's float leaves are cast to
``cfg.compute_dtype`` where it runs, as the reference's ``constrain_tree``
does: at full width every weight, ``u``, ``w0``, the ``maa*`` mixers and
``ln_x`` are bf16 there, and a bf16 weight met by an f32 activation gives
an f32 product (JAX's promotion), while ``wr``/``wk``/``wv``/``wg``/``wo``
products of bf16 inputs are returned in bf16.

Decode state is O(1) per layer: the (H, hd, hd) f32 wkv state and the
last token's input to each mix. ``decode_step`` updates the cache tensors
in place (the kernel writes each layer's new state over the old one).

Across a mesh (``launch.mesh``; the sharded engine) each layer is placed
at ``layer_specs`` where it runs (the reference's ``constrain_tree``), and
r/k/v go over heads at the reference's site. The decay ``lw`` and the
bonus ``u``, which the reference leaves to its compiler, reach B6 on the
same heads: each rank runs the scan on its own heads
(``launch.mesh.local_heads``), with its own heads' wkv state (the cache
holds only those, ``cache_specs``), and the per-head group norm stays
local; ``wo``'s and the channel mix's ``wv`` partial sums are added in
f32 (``common.matmul_f32``). The shifts are replicated, whole on every
rank.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rwkv6_scan import wkv6_chunked, wkv6_train
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.mesh import BATCH, MODEL, shard
from repro_torch.models import common
from repro_torch.models.common import ParamTree, frozen, layer_norm, matmul_f32

MIX_RANK = 32
DECAY_RANK = 64


def _n_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.ssm_head_dim


def _norm(d: int, dtype) -> ParamTree:
    return ParamTree(w=torch.ones((d,), dtype=dtype), b=torch.zeros((d,), dtype=dtype))


def _init_layer(cfg: ModelConfig, g: torch.Generator, dtype) -> ParamTree:
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.ssm_head_dim
    f32 = torch.float32
    out_scale = 1.0 / (2 * cfg.n_layers) ** 0.5
    return ParamTree(
        ln1=_norm(d, dtype),
        ln2=_norm(d, dtype),
        att=ParamTree(
            maa_x=torch.zeros((d,), dtype=f32),
            maa=torch.zeros((5, d), dtype=f32),  # w, k, v, r, g
            maa_w1=common.dense_init((d, 5 * MIX_RANK), g, scale=0.1, dtype=f32),
            maa_w2=common.dense_init((5, MIX_RANK, d), g, in_axis=1, scale=0.1, dtype=f32),
            w0=torch.full((d,), -6.0, dtype=f32),  # decay bias: slow decay default
            w1=common.dense_init((d, DECAY_RANK), g, scale=0.1, dtype=f32),
            w2=common.dense_init((DECAY_RANK, d), g, scale=0.1, dtype=f32),
            u=torch.full((_n_heads(cfg), hd), 0.5, dtype=f32),  # "time_faaaa" bonus
            wr=common.dense_init((d, d), g, dtype=dtype),
            wk=common.dense_init((d, d), g, dtype=dtype),
            wv=common.dense_init((d, d), g, dtype=dtype),
            wg=common.dense_init((d, d), g, dtype=dtype),
            wo=common.dense_init((d, d), g, scale=out_scale, dtype=dtype),
            ln_x=_norm(d, f32),
        ),
        ffn=ParamTree(
            maa_k=torch.zeros((d,), dtype=f32),
            maa_r=torch.zeros((d,), dtype=f32),
            wk=common.dense_init((d, f), g, dtype=dtype),
            wv=common.dense_init((f, d), g, scale=out_scale, dtype=dtype),
            wr=common.dense_init((d, d), g, dtype=dtype),
        ),
    )


class RWKV6(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: torch.Generator, device=None):
        super().__init__()
        dtype = common.dt(cfg.param_dtype)
        d, vp = cfg.d_model, cfg.padded_vocab
        self.embed = frozen(common.embed_init((vp, d), generator, dtype), device)
        self.ln0 = _norm(d, dtype).to(device)
        # drawn on the CPU and moved one layer at a time: host memory holds one layer
        self.layers = nn.ModuleList(_init_layer(cfg, generator, dtype).to(device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _norm(d, dtype).to(device)
        self.lm_head = frozen(common.dense_init((d, vp), generator, dtype=dtype), device)


def init(cfg: ModelConfig, generator: torch.Generator, device=None) -> RWKV6:
    """Random init drawn on the CPU from ``generator``, placed on ``device``."""
    return RWKV6(cfg, generator, device)


def layer_specs(cfg: ModelConfig) -> dict:
    """Compute-time (TP) specs for one layer."""
    rep1 = (None,)
    return {
        "ln1": {"w": rep1, "b": rep1},
        "ln2": {"w": rep1, "b": rep1},
        "att": {
            "maa_x": rep1, "maa": (None, None), "maa_w1": (None, None), "maa_w2": (None, None, None),
            "w0": rep1, "w1": (None, None), "w2": (None, None), "u": (MODEL, None),
            "wr": (None, MODEL), "wk": (None, MODEL), "wv": (None, MODEL), "wg": (None, MODEL),
            "wo": (MODEL, None), "ln_x": {"w": rep1, "b": rep1},
        },
        "ffn": {"maa_k": rep1, "maa_r": rep1, "wk": (None, MODEL), "wv": (MODEL, None), "wr": (None, None)},
    }


def param_specs(cfg: ModelConfig) -> dict:
    from repro_torch.models.transformer import stacked

    rep1 = (None,)
    return {"embed": (MODEL, None), "ln0": {"w": rep1, "b": rep1}, "layers": stacked(layer_specs(cfg)),
            "final_norm": {"w": rep1, "b": rep1}, "lm_head": (None, MODEL)}


def cache_specs(cfg: ModelConfig, model_axis: int = 16) -> dict:
    return {"wkv": (None, BATCH, MODEL, None, None), "att_shift": (None, BATCH, None),
            "cm_shift": (None, BATCH, None), "lengths": (BATCH,)}


# ---------------------------------------------------------------------------
# blocks


def _token_shift(x, prev):
    """x: (B, T, D); prev: (B, D), the last token of the previous segment
    (a cache's shift: the same rows as x, this rank's where x is split over
    the batch axes)."""
    return torch.cat([meshlib.rows_like(prev, x)[:, None, :], x[:, :-1, :]], dim=1)


def _time_mix(att: dict, cfg: ModelConfig, x, shift_prev, wkv_state, inplace: bool = True):
    """Returns (out (B, T, D), new shift (B, D), new wkv state). A given
    ``wkv_state`` (decode's, the cache's own tensor) is updated in place
    unless ``inplace`` is False, when the new state is a new tensor. A
    training forward (``common.needs_grad``) takes ``wkv6_train``, which
    never writes a given state."""
    b, t, d = x.shape
    hd = cfg.ssm_head_dim
    h = d // hd
    dtype = x.dtype
    xf = x.float()
    sx = _token_shift(xf, shift_prev) - xf
    xxx = xf + sx * att["maa_x"]
    mix = torch.tanh(matmul_f32(xxx, att["maa_w1"])).reshape(b, t, 5, MIX_RANK)
    eq = "btfr,frd->fbtd"  # (5, B, T, D); across a mesh on each rank's rows
    w2 = att["maa_w2"].float()
    local = meshlib.local_einsum(eq, mix, w2) if meshlib.is_dtensor(mix) else None
    mix = torch.einsum(eq, mix, w2) if local is None else local
    xw, xk, xv, xr, xg = [xf + sx * (att["maa"][i] + mix[i]) for i in range(5)]

    def proj(xx, w):  # bf16 x bf16 -> bf16 at full width, then f32
        return matmul_f32(xx.to(dtype), w).to(dtype).float()

    def heads(xx, w):  # (B, T, H, hd) over heads (the reference's constraint): this rank's, plain
        return meshlib.local_heads(meshlib.split_last(proj(xx, w), (h, hd)), 2)

    r, k, v = heads(xr, att["wr"]), heads(xk, att["wk"]), heads(xv, att["wv"])
    g = F.silu(proj(xg, att["wg"]))
    lw = -torch.exp(att["w0"] + matmul_f32(matmul_f32(xw, att["w1"]), att["w2"])).reshape(b, t, h, hd)
    lw = meshlib.local_heads(lw, 2)
    u = meshlib.local_heads(att["u"].float(), 0, like=x).contiguous()
    if common.needs_grad(r, k, v, lw, u, wkv_state):
        y, wkv_state = wkv6_train(r, k, v, lw, u, wkv_state)
    else:
        y, wkv_state = wkv6_chunked(r, k, v, lw, u, wkv_state, inplace=inplace and wkv_state is not None)
    # per-head group norm (on this rank's heads), then gate and output projection
    mu = y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, keepdim=True, unbiased=False)
    yn = meshlib.from_heads((y - mu) * torch.rsqrt(var + 64e-5), 2, (b, t, h, hd), like=x).reshape(b, t, d)
    yn = yn * att["ln_x"]["w"] + att["ln_x"]["b"]
    out = matmul_f32((yn * g).to(dtype), att["wo"]).to(dtype)
    return out, meshlib.local_rows(xf[:, -1, :]), wkv_state


def _channel_mix(ffn: dict, x, shift_prev):
    dtype = x.dtype
    xf = x.float()
    sx = _token_shift(xf, shift_prev) - xf
    xk = (xf + sx * ffn["maa_k"]).to(dtype)
    xr = (xf + sx * ffn["maa_r"]).to(dtype)
    k = torch.square(torch.relu(matmul_f32(xk, ffn["wk"]).to(dtype)))
    kv = matmul_f32(k, ffn["wv"]).to(dtype)
    gate = torch.sigmoid(matmul_f32(xr, ffn["wr"]).to(dtype).float()).to(dtype)
    return gate * kv, meshlib.local_rows(xf[:, -1, :])


def _block(layer: dict, cfg: ModelConfig, h, att_shift, cm_shift, wkv_state, inplace: bool = True):
    x = layer_norm(h, layer["ln1"]["w"], layer["ln1"]["b"], cfg.norm_eps)
    a, att_shift, wkv_state = _time_mix(layer["att"], cfg, x, att_shift, wkv_state, inplace)
    h = h + a
    x = layer_norm(h, layer["ln2"]["w"], layer["ln2"]["b"], cfg.norm_eps)
    m, cm_shift = _channel_mix(layer["ffn"], x, cm_shift)
    return shard(h + m, BATCH, None, None), att_shift, cm_shift, wkv_state


def _embed(params: RWKV6, cfg: ModelConfig, tokens, gather: bool = False):
    """The embedding rows of ``tokens`` through ``ln0``; ``gather`` (the
    training trunk's) places the table and the norm at their compute specs
    where they are used (a pooled parameter gathered, ``common.cast``)."""
    emb = common.cast(params, "embed", None, (MODEL, None) if gather else None)
    ln0 = params.ln0.tree(None, {"w": (None,), "b": (None,)} if gather else None)
    h = meshlib.take_rows(emb, tokens).to(common.dt(cfg.compute_dtype))
    h = layer_norm(shard(h, BATCH, None, None), ln0["w"], ln0["b"], cfg.norm_eps)
    return shard(h, BATCH, None, None)


def _logits(params: RWKV6, cfg: ModelConfig, h):
    fn = params.final_norm.tree()
    h = layer_norm(h, fn["w"], fn["b"], cfg.norm_eps)
    return shard(matmul_f32(h, common.cast(params, "lm_head", h.dtype)), BATCH, None, MODEL)


def _layers(params: RWKV6, cfg: ModelConfig, h):
    """Every layer from zero shifts and a zero state; yields (h, shifts, state)."""
    b, _, d = h.shape
    cdt = common.dt(cfg.compute_dtype)
    specs = layer_specs(cfg)
    for blk in params.layers:
        z = torch.zeros((b, d), dtype=torch.float32, device=h.device)
        h, a_s, c_s, s = _block(blk.tree(cdt, specs), cfg, h, z, z, None)
        yield h, a_s, c_s, s


# ---------------------------------------------------------------------------
# public API


def features(params: RWKV6, cfg: ModelConfig, tokens, *, remat: Optional[bool] = None):
    """Trunk -> (post-final-norm h (B, T, D), ``lm_head`` as stored), the
    reference's ``features``: every layer from zero shifts and a zero wkv
    state, its float leaves cast to the compute dtype where it runs (casts
    that carry the gradient), under ``cfg.remat_policy`` per layer when
    ``remat`` (default ``cfg.remat``). Runs with autograd; the scan is
    ``wkv6_train`` (B6 on the card, twice a layer with remat: the forward
    and its recompute). ``forward`` is the serving form."""
    h = _embed(params, cfg, tokens, gather=True)
    b, _, d = h.shape
    cdt = common.dt(cfg.compute_dtype)
    specs = layer_specs(cfg)

    def block(h, blk):
        z = torch.zeros((b, d), dtype=torch.float32, device=h.device)
        return _block(blk.tree(cdt, specs), cfg, h, z, z, None, inplace=False)[0]

    block = common.maybe_remat(block, cfg.remat if remat is None else remat, cfg.remat_policy)
    for blk in params.layers:
        h = block(h, blk)
    fn = params.final_norm.tree(None, {"w": (None,), "b": (None,)})
    h = layer_norm(h, fn["w"], fn["b"], cfg.norm_eps)
    return h, common.cast(params, "lm_head", None, (None, MODEL))


@torch.no_grad()
def forward(params: RWKV6, cfg: ModelConfig, tokens):
    """Full-sequence forward -> logits (B, T, Vp) f32."""
    h = _embed(params, cfg, tokens)
    for h, *_ in _layers(params, cfg, h):
        pass
    return _logits(params, cfg, h)


@torch.no_grad()
def prefill(params: RWKV6, cfg: ModelConfig, tokens, *, max_len: int = 0):
    """Forward that also returns the recurrent state as the cache."""
    h = _embed(params, cfg, tokens)
    b, t, _ = h.shape
    states = []
    for h, a_s, c_s, s in _layers(params, cfg, h):
        states.append((s, a_s, c_s))
    cache = {
        "wkv": torch.stack([s for s, _, _ in states]),
        "att_shift": torch.stack([a for _, a, _ in states]),
        "cm_shift": torch.stack([c for _, _, c in states]),
        "lengths": torch.full((b,), t, dtype=torch.int32, device=h.device),
    }
    return _logits(params, cfg, h), cache


@torch.no_grad()
def decode_step(params: RWKV6, cfg: ModelConfig, cache: dict, tokens, *, page_size: int = 16,
                active: Optional[torch.Tensor] = None):
    """One decode step. tokens: (B, 1). Returns (logits, cache').

    The cache's state tensors are updated in place; the returned cache holds
    the same tensors and the advanced lengths. A given (B,) bool ``active``
    gates the step per row, as the reference's chunk column gates every
    cache leaf: the scan then writes its new state into a new tensor, and
    only the active rows of it, of the shifts and of the lengths are
    committed, so an inactive row keeps every leaf bit for bit.
    ``page_size`` is taken for the engine's sake and unused: the state has
    no pages.
    """
    cdt = common.dt(cfg.compute_dtype)
    h = _embed(params, cfg, tokens)
    specs = layer_specs(cfg)
    for i, blk in enumerate(params.layers):
        h, a_s, c_s, s = _block(blk.tree(cdt, specs), cfg, h, cache["att_shift"][i], cache["cm_shift"][i],
                                cache["wkv"][i], inplace=active is None)
        if active is not None:
            common.commit(cache["wkv"][i], s, active)
        common.commit(cache["att_shift"][i], a_s, active)
        common.commit(cache["cm_shift"][i], c_s, active)
    return _logits(params, cfg, h), {**cache, "lengths": common.advance(cache["lengths"], active)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
    d, hd = cfg.d_model, cfg.ssm_head_dim
    del max_len, dtype  # O(1) state, all f32
    f32 = torch.float32
    return {
        "wkv": torch.zeros((cfg.n_layers, batch, d // hd, hd, hd), dtype=f32, device=device),
        "att_shift": torch.zeros((cfg.n_layers, batch, d), dtype=f32, device=device),
        "cm_shift": torch.zeros((cfg.n_layers, batch, d), dtype=f32, device=device),
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
