"""The work of the ``moe`` family (granite-moe) for the harness, from a
configuration's sizes (its ``port`` block): the model FLOPs of a token,
and the attention kernels' launches of a prefill (B5) and of a decode step
(B4) with what each moves and computes (``frozen/work.py``).

Model FLOPs are two a multiply-add of every product a token goes through:
its q/k/v/o projections, the router, its ``top_k`` experts only (three
products each), the head, and attention's ``4 H d`` a key over the
token's whole context."""
from __future__ import annotations

from bench.frozen import work

BF16 = 2  # bytes of the attention kernels' operands and of the cache


def _dims(cfg: dict):
    hq = cfg["n_heads"]
    return hq, cfg["n_kv_heads"], cfg["d_model"] // hq


def flops_per_token(cfg: dict, pos: int) -> float:
    """FLOPs of one token at position ``pos`` (0-based; context ``pos + 1``)."""
    d = cfg["d_model"]
    hq, hkv, hd = _dims(cfg)
    attn = 2 * d * (hq + 2 * hkv) * hd + 2 * hq * hd * d + 4 * hq * hd * (pos + 1)
    layer = attn + 2 * d * cfg["n_experts"] + cfg["top_k"] * 6 * d * cfg["moe_d_ff"]
    return cfg["n_layers"] * layer + 2 * d * cfg["vocab_size"]


def prefill_calls(cfg: dict, t: int) -> dict:
    """Kernel -> the work of each launch of a whole-slot prefill of ``t`` tokens."""
    hq, hkv, hd = _dims(cfg)
    return {"flash_attention": [work.flash_attention(1, hq, hkv, t, t, hd, BF16, True)] * cfg["n_layers"]}


def decode_calls(cfg: dict, engine: dict, kv_len) -> dict:
    """Kernel -> the work of each launch of one whole-batch decode step,
    ``kv_len`` each row's keys after the step."""
    hq, hkv, hd = _dims(cfg)
    pages = engine["max_len"] // engine["page_size"]
    return {"paged_attention": [work.paged_attention(engine["max_batch"], hq, hkv, hd, BF16, BF16, pages,
                                                     engine["page_size"], kv_len)] * cfg["n_layers"]}
