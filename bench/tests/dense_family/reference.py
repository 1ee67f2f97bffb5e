"""Plain reference of a ``dense`` family, for the test that adds a cell of
a family the benchmark does not have from new files alone (it is copied to
``bench/reference/dense.py`` of a test's checkout): pre-norm GQA attention
and a SwiGLU MLP a layer; logits ``rms(h) W_head`` over the first
``vocab_size`` columns, or the tied embedding's rows."""
from __future__ import annotations

import torch

from bench.reference.common import Precision, causal_attention, rms_norm, rope, swiglu


def forward(w: dict, cfg: dict, tokens, prec: Precision = Precision()):
    """tokens (T,) -> (logits (T, vocab_size) f32, k (L, T, Hkv, D), v (L, T, Hkv, D))."""
    n_l, d, hq, hkv = cfg["n_layers"], cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    hd, eps, t = d // hq, cfg["norm_eps"], tokens.shape[0]
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
        h = h + swiglu(rms_norm(h, p("ln2"), eps), p("mlp.w_gate"), p("mlp.w_up"), p("mlp.w_down"), prec)
    head = w["lm_head"][:, : cfg["vocab_size"]] if "lm_head" in w else w["embed"][: cfg["vocab_size"]].T
    logits = prec.mm(rms_norm(h, w["final_norm"], eps), head)
    return logits, torch.stack(ks), torch.stack(vs)
