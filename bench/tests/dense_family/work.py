"""The work of a ``dense`` family, for the test that adds a cell of a
family the benchmark does not have from new files alone (it is copied to
``bench/families/dense.py`` of a test's checkout)."""
from __future__ import annotations

from bench.frozen import work


def _dims(cfg: dict):
    return cfg["n_heads"], cfg["n_kv_heads"], cfg["d_model"] // cfg["n_heads"]


def flops_per_token(cfg: dict, pos: int) -> float:
    d = cfg["d_model"]
    hq, hkv, hd = _dims(cfg)
    layer = 2 * d * (hq + 2 * hkv) * hd + 2 * hq * hd * d + 4 * hq * hd * (pos + 1) + 6 * d * cfg["d_ff"]
    return cfg["n_layers"] * layer + 2 * d * cfg["vocab_size"]


def prefill_calls(cfg: dict, t: int) -> dict:
    hq, hkv, hd = _dims(cfg)
    return {"flash_attention": [work.flash_attention(1, hq, hkv, t, t, hd, 2, True)] * cfg["n_layers"]}


def decode_calls(cfg: dict, engine: dict, kv_len) -> dict:
    hq, hkv, hd = _dims(cfg)
    pages = engine["max_len"] // engine["page_size"]
    return {"paged_attention": [work.paged_attention(engine["max_batch"], hq, hkv, hd, 2, 2, pages,
                                                     engine["page_size"], kv_len)] * cfg["n_layers"]}
