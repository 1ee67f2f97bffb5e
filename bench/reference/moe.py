"""Plain reference of the ``moe`` family (granite-moe): a decoder whose
MLP is top-k routed experts without a capacity bound.

Per layer, pre-norm: ``h += Wo attn(RoPE(Wq x), RoPE(Wk x), Wv x)`` with
``x = rms(h)``; then ``p = softmax(rms(h) Wr)``, the k largest ``p_e``
renormalised to sum 1, and ``h += sum_e p_e (silu(x Wg_e) * x Wu_e) Wd_e``.
Logits ``rms(h) E^T`` over the tied embedding's first ``vocab_size`` rows.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference.common import Precision, causal_attention, rms_norm, rope


def forward(w: dict, cfg: dict, tokens: torch.Tensor, prec: Precision = Precision()):
    """tokens (T,) -> (logits (T, vocab_size) f32, k (L, T, Hkv, D), v (L, T, Hkv, D)),
    k after its rotary embedding, as a cache holds it."""
    n_l, d, hq, hkv = cfg["n_layers"], cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    hd, eps, top_k = d // hq, cfg["norm_eps"], cfg["top_k"]
    t = tokens.shape[0]
    h = w["embed"][tokens.long()].float()
    ks, vs = [], []
    for i in range(n_l):
        p = lambda n: w[f"layers.{i}.{n}"]
        x = rms_norm(h, p("ln1"), eps)
        q = rope(prec.mm(x, p("attn.wq")).view(t, hq, hd), cfg["rope_theta"])
        k = rope(prec.mm(x, p("attn.wk")).view(t, hkv, hd), cfg["rope_theta"])
        v = prec.mm(x, p("attn.wv")).view(t, hkv, hd)
        ks.append(k)
        vs.append(v)
        h = h + prec.mm(causal_attention(q, k, v, prec).reshape(t, hq * hd), p("attn.wo"))
        x = rms_norm(h, p("ln2"), eps)
        probs = torch.softmax(prec.mm(x, p("router")), dim=-1)
        top_p, top_e = probs.topk(top_k, dim=-1)
        top_p = top_p / top_p.sum(-1, keepdim=True)
        y = torch.zeros_like(h)
        for e in range(cfg["n_experts"]):
            rows, slot = (top_e == e).nonzero(as_tuple=True)
            if rows.numel() == 0:
                continue
            xe = x[rows]
            he = F.silu(prec.mm(xe, p("experts.w_gate")[e])) * prec.mm(xe, p("experts.w_up")[e])
            y.index_add_(0, rows, prec.mm(he, p("experts.w_down")[e]) * top_p[rows, slot, None])
        h = h + y
    logits = prec.mm(rms_norm(h, w["final_norm"], eps), w["embed"][: cfg["vocab_size"]].T)
    return logits, torch.stack(ks), torch.stack(vs)
