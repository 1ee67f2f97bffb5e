"""Mixture-of-Experts LM (granite-moe / qwen2-moe), forward only (mirrors
repro/models/moe.py).

The dense transformer with its MLP replaced by top-k routed experts under a
capacity bound, plus the shared expert where the config has one. Routing
and both dispatch backends follow the reference op for op:

* ``einsum`` (the configs' default): GShard one-hot dispatch and combine
  products. A slot's place in its expert's queue is a cumulative sum over
  the group's (token, k) slots in order, so the rows of a routing group
  are coupled: an earlier row can push a later one past capacity.
* ``sort``: slots sorted by expert into an (E, C, D) buffer, the experts
  run as one batched product, and each token's k outputs gathered back.

Three choices keep the port's routing books the reference's, and the
serving path free of host reads so the engine can capture it as a graph:

* top-k is the first k of a STABLE descending sort, so among equal
  probabilities the lower expert id wins, as in ``jax.lax.top_k``
  (``torch.topk`` promises no order for ties);
* one-hot is a comparison with an index range (an out-of-range index gives
  a zero row, as ``jax.nn.one_hot`` does, and nothing is checked on the
  host), and the sort backend's expert counts are a fixed-length
  ``scatter_add_``, not ``bincount``;
* the sort backend combines by gathering each token's k slot outputs back
  through the sort's permutation and adding them in ascending expert
  order, a fixed order, where the reference scatter-adds (an atomic
  ``index_add_`` would change from run to run on the card).

A decode routes the whole batch as one group (G = 1, T = B), inactive rows
included: the engine's ``active`` gate keeps their cache entries, never
takes them out of the group, and they attend over their new K/V as the
reference computes them (``attention.apply_decode_every_row``). Layer
weights are cast to the compute dtype where the layer runs, every float
leaf (router and shared gate too), as the reference's ``constrain_tree``.
The expert products are plain batched products through
``common.matmul_f32``; attention is ``models/attention`` as in the dense
family (the flash and paged kernels on the card).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common, transformer
from repro_torch.models.common import ParamTree

# ---------------------------------------------------------------------------
# init


def _init_layer(cfg: ModelConfig, g: torch.Generator, dtype) -> ParamTree:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    out_scale = 1.0 / (2 * cfg.n_layers) ** 0.5
    p = dict(
        ln1=torch.ones((d,), dtype=dtype),
        ln2=torch.ones((d,), dtype=dtype),
        attn=transformer.init_attn(cfg, g, dtype),
        router=common.dense_init((d, e), g, dtype=torch.float32),
        experts=ParamTree(
            w_gate=common.dense_init((e, d, f), g, in_axis=1, dtype=dtype),
            w_up=common.dense_init((e, d, f), g, in_axis=1, dtype=dtype),
            w_down=common.dense_init((e, f, d), g, in_axis=1, scale=out_scale, dtype=dtype),
        ),
    )
    if cfg.n_shared_experts:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        p["shared"] = ParamTree(
            w_gate=common.dense_init((d, fs), g, dtype=dtype),
            w_up=common.dense_init((d, fs), g, dtype=dtype),
            w_down=common.dense_init((fs, d), g, scale=out_scale, dtype=dtype),
            gate=common.dense_init((d, 1), g, dtype=dtype),
        )
    return ParamTree(**p)


def init(cfg: ModelConfig, generator: torch.Generator, device=None) -> transformer.Transformer:
    """Random init drawn on the CPU from ``generator``, placed on ``device``."""
    return transformer.Transformer(cfg, generator, device, init_layer=_init_layer)


# ---------------------------------------------------------------------------
# routing


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot over ``n`` classes; an index outside [0, n) gives zeros."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(torch.float32)


def _top_k(x: torch.Tensor, k: int):
    """The k largest along the last axis, the lower index first among ties."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _route(router_w: torch.Tensor, cfg: ModelConfig, xg: torch.Tensor):
    """xg: (G, T, D) -> (topv, topi, probs). topv renormalized over top_k."""
    logits = common.matmul_f32(xg, router_w)  # (G,T,E) f32
    probs = torch.softmax(logits, dim=-1)
    topv, topi = _top_k(probs, cfg.top_k)
    topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)
    return topv, topi, probs


def aux_losses(probs: torch.Tensor, topi: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """GShard load-balance loss (training-side; no serving path calls it).
    probs (G,T,E), topi (G,T,k)."""
    e = cfg.n_experts
    frac = _one_hot(topi, e).mean(dim=(1, 2))  # (G,E)
    imp = probs.mean(dim=1)  # (G,E)
    lb = e * (frac * imp).sum(-1).mean()
    return cfg.router_aux_coef * lb


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    c = int(tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(4, -(-c // 4) * 4)


def _expert_ffn(experts: dict, xs: torch.Tensor) -> torch.Tensor:
    """xs: (G, E, C, D) -> (G, E, C, D)."""
    g = common.matmul_f32(xs, experts["w_gate"])
    u = common.matmul_f32(xs, experts["w_up"])
    h = (F.silu(g) * u).to(xs.dtype)
    return common.matmul_f32(h, experts["w_down"]).to(xs.dtype)


def moe_einsum(p: dict, cfg: ModelConfig, xg: torch.Tensor):
    """GShard dispatch. xg: (G, T, D) -> (out (G, T, D), keep (G, T, k) bool)."""
    gdim, t, d = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    c = _capacity(t, cfg)
    topv, topi, _ = _route(p["router"], cfg, xg)
    oh = _one_hot(topi, e)  # (G,T,k,E)
    # position of each slot within its expert: cumsum over (T,k) in slot order
    ohf = oh.reshape(gdim, t * k, e)
    pos = torch.cumsum(ohf, dim=1) - ohf  # (G,T*k,E)
    slot_pos = (pos * ohf).sum(-1).reshape(gdim, t, k)  # (G,T,k)
    keep = slot_pos < c
    keepf = keep.to(torch.float32)
    cap_oh = _one_hot(slot_pos.long(), c)  # (G,T,k,C)
    disp = torch.einsum("gtke,gtkc->gtec", oh * keepf[..., None], cap_oh)  # (G,T,E,C)
    comb = torch.einsum("gtke,gtkc->gtec", oh * (topv * keepf)[..., None], cap_oh)
    # "gtec,gtd->gecd": each (e, c) takes at most one token, so exact
    xs = common.matmul_f32(disp.reshape(gdim, t, e * c).transpose(1, 2), xg)
    ys = _expert_ffn(p["experts"], xs.to(xg.dtype).reshape(gdim, e, c, d))
    out = common.matmul_f32(comb.to(ys.dtype).reshape(gdim, t, e * c), ys.reshape(gdim, e * c, d))
    return out.to(xg.dtype), keep


def _sort_group(p: dict, cfg: ModelConfig, x, ti, tv, c: int):
    """One routing group of ``moe_sort``: x (T, D), ti/tv (T, k)."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    flat_e = ti.reshape(t * k)
    flat_w = tv.reshape(t * k)
    order = torch.sort(flat_e, stable=True).indices  # slots sorted by expert
    se = flat_e[order]
    counts = torch.zeros((e,), dtype=torch.int64, device=x.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=x.device) - starts[se]
    keep = pos < c
    dest = torch.where(keep, se * c + pos, e * c)  # drop slot -> scratch row
    tok = order // k
    buf = torch.zeros((e * c + 1, d), dtype=x.dtype, device=x.device)
    buf[dest] = x[tok]
    ys = _expert_ffn(p["experts"], buf[: e * c].reshape(1, e, c, d))[0].reshape(e * c, d)
    y_slot = ys[dest.clamp(max=e * c - 1)] * (keep.to(torch.float32) * flat_w[order])[:, None].to(x.dtype)
    # back to (token, k) order through the sort's permutation, then each
    # token's k outputs added in ascending expert order
    y_tok = torch.empty_like(y_slot).index_copy_(0, order, y_slot).reshape(t, k, d)
    by_expert = torch.sort(ti, dim=-1, stable=True).indices
    y_tok = y_tok.gather(1, by_expert[..., None].expand(t, k, d))
    out = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for j in range(k):
        out = out + y_tok[:, j]
    keep_tok = torch.empty_like(keep).index_copy_(0, order, keep).reshape(t, k)
    return out, keep_tok


def moe_sort(p: dict, cfg: ModelConfig, xg: torch.Tensor):
    """Sort-based dispatch. xg: (G, T, D) -> (out (G, T, D), keep (G, T, k))."""
    c = _capacity(xg.shape[1], cfg)
    topv, topi, _ = _route(p["router"], cfg, xg)
    outs = [_sort_group(p, cfg, xg[i], topi[i], topv[i], c) for i in range(xg.shape[0])]
    return torch.stack([o for o, _ in outs]), torch.stack([kp for _, kp in outs])


def _shared_ffn(p: dict, x: torch.Tensor) -> torch.Tensor:
    s = p["shared"]
    gate = torch.sigmoid(common.matmul_f32(x, s["gate"]))
    y = common.swiglu(x, s["w_gate"], s["w_up"], s["w_down"])
    return (y.float() * gate).to(x.dtype)


def moe_ffn(p: dict, cfg: ModelConfig, x: torch.Tensor, dispatch: Optional[str] = None):
    """x: (B, S, D) -> (B, S, D). Routed per batch row (group = row); a
    sequence longer than ``cfg.moe_group`` and a multiple of it is routed
    in groups of ``cfg.moe_group`` tokens, as in the reference."""
    dispatch = dispatch or cfg.moe_dispatch
    fn = moe_einsum if dispatch == "einsum" else moe_sort
    g0, t0, d0 = x.shape
    grp = cfg.moe_group
    if grp and t0 > grp and t0 % grp == 0:
        x = x.reshape(g0 * (t0 // grp), grp, d0)
    out, _keep = fn(p, cfg, x)
    out = out.reshape(g0, t0, d0)
    if cfg.n_shared_experts:
        out = out + _shared_ffn(p, x.reshape(g0, t0, d0))
    return out


# ---------------------------------------------------------------------------
# serving (mirrors transformer.py; MLP -> MoE)


@torch.no_grad()
def prefill(params: transformer.Transformer, cfg: ModelConfig, tokens, *, max_len: int,
            block_k: int = 1024, dispatch: Optional[str] = None):
    """Forward + KV cache construction. Returns (logits, cache)."""
    cdt = common.dt(cfg.compute_dtype)
    h = transformer._embed_in(params, cfg, tokens)
    b, l, _ = h.shape
    positions = common.causal_positions(b, l, h.device)
    ks, vs = [], []
    for blk in params.layers:
        layer = blk.tree(cdt)
        x = common.rms_norm(h, layer["ln1"], cfg.norm_eps)
        a, (k, v) = attention.apply_prefill(layer["attn"], cfg, x, positions, max_len,
                                            block_k=block_k)
        h = h + a
        x = common.rms_norm(h, layer["ln2"], cfg.norm_eps)
        h = h + moe_ffn(layer, cfg, x, dispatch)
        ks.append(k.to(torch.bfloat16))
        vs.append(v.to(torch.bfloat16))
    cache = {
        "k": torch.stack(ks),
        "v": torch.stack(vs),
        "lengths": torch.full((b,), l, dtype=torch.int32, device=h.device),
    }
    return transformer._logits_out(params, cfg, h), cache


@torch.no_grad()
def decode_step(params: transformer.Transformer, cfg: ModelConfig, cache: dict, tokens, *,
                page_size: int = 16, active: Optional[torch.Tensor] = None,
                dispatch: Optional[str] = None):
    """One decode step, the batch routed as one group. tokens: (B, 1).
    Returns (logits, cache'); K/V are written in place, and a row where a
    given (B,) bool ``active`` is False keeps its K/V and its length (it
    still takes part in the routing group, as in the reference)."""
    cdt = common.dt(cfg.compute_dtype)
    h = transformer._embed_in(params, cfg, tokens)
    lengths = cache["lengths"]
    b = h.shape[0]
    for i, blk in enumerate(params.layers):
        layer = blk.tree(cdt)
        x = common.rms_norm(h, layer["ln1"], cfg.norm_eps)
        h = h + attention.apply_decode_every_row(layer["attn"], cfg, x, cache["k"][i],
                                                 cache["v"][i], lengths, page_size, active)
        x = common.rms_norm(h, layer["ln2"], cfg.norm_eps)
        h = h + moe_ffn(layer, cfg, x.reshape(1, b, -1), dispatch).reshape(b, 1, -1)
    logits = transformer._logits_out(params, cfg, h)
    return logits, {"k": cache["k"], "v": cache["v"], "lengths": common.advance(lengths, active)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
    return attention.init_cache(cfg, cfg.n_layers, batch, max_len, dtype, device)
