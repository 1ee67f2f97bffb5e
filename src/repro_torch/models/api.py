"""Model API for the port (mirrors repro/models/api.py, serving subset).

Every family of the reference is ported: dense (``transformer``), moe
(``moe``), ssm (``rwkv6``), hybrid (``zamba2``), vlm (``vlm``: embeds and
M-RoPE positions in) and audio (``whisper``: tokens and audio frames in).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import moe, rwkv6, transformer, vlm, whisper, zamba2

_PORTED = {"dense": transformer, "moe": moe, "ssm": rwkv6, "hybrid": zamba2, "vlm": vlm,
           "audio": whisper}


@dataclasses.dataclass
class ModelAPI:
    cfg: ModelConfig

    @property
    def family(self) -> str:
        return self.cfg.family

    def init(self, seed: int = 0, device=None) -> torch.nn.Module:
        """Random-init params from ``torch.Generator().manual_seed(seed)``,
        drawn on the CPU and placed on ``device`` (None -> the CUDA card)."""
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        return _PORTED[self.family].init(self.cfg, gen, device=dev)

    def init_cache(self, batch: int, max_len: int, device=None) -> dict:
        return _PORTED[self.family].init_cache(
            self.cfg, batch, max_len, device=resolve_device(device)
        )

    def prefill(self, params, batch: dict, *, max_len: int):
        """The reference's batch keys: ``embeds`` and ``mrope_positions`` for
        vlm, ``tokens`` and ``frames`` for audio, ``tokens`` otherwise."""
        mod, cfg = _PORTED[self.family], self.cfg
        if self.family == "vlm":
            return mod.prefill(params, cfg, batch["embeds"], batch["mrope_positions"], max_len=max_len)
        if self.family == "audio":
            return mod.prefill(params, cfg, batch["tokens"], batch["frames"], max_len=max_len)
        return mod.prefill(params, cfg, batch["tokens"], max_len=max_len)

    def decode(self, params, cache: dict, tokens, *, page_size: int = 16, active=None):
        """One decode step, the cache updated in place; a given (B,) bool
        ``active`` leaves every cache leaf of its False rows as it was."""
        return _PORTED[self.family].decode_step(params, self.cfg, cache, tokens,
                                                page_size=page_size, active=active)


def get_model(cfg: ModelConfig) -> ModelAPI:
    return ModelAPI(cfg)


def kernel_launches(cfg: ModelConfig, prefills: int, decodes: int) -> dict:
    """The model kernels' launches on the card over ``prefills`` prefill and
    ``decodes`` decode dispatches: attention once per dense, moe or vlm layer
    or per application of zamba2's shared block (flash in prefill, paged in
    decode), and a scan once per recurrent layer in either. The moe family
    launches as the dense one (its experts are plain products), and so does
    vlm (the dense backbone). Whisper's prefill runs flash in every encoder
    layer and twice in every decoder layer (self- and cross-attention), its
    decode paged (self) and flash (cross) once a decoder layer."""
    n = cfg.n_layers
    if cfg.family in ("dense", "moe", "vlm"):
        return {"flash_attention": n * prefills, "paged_attention": n * decodes, "wkv6": 0, "ssd": 0}
    if cfg.family == "audio":
        return {"flash_attention": (cfg.n_encoder_layers + 2 * n) * prefills + n * decodes,
                "paged_attention": n * decodes, "wkv6": 0, "ssd": 0}
    if cfg.family == "ssm":
        return {"flash_attention": 0, "paged_attention": 0, "wkv6": n * (prefills + decodes), "ssd": 0}
    apps = zamba2.n_attn_apps(cfg)
    return {"flash_attention": apps * prefills, "paged_attention": apps * decodes, "wkv6": 0,
            "ssd": n * (prefills + decodes)}


def make_serve_step(api: ModelAPI, *, vocab: Optional[int] = None, page_size: int = 16):
    """(params, cache, tokens (B,1), active=None) -> (greedy next_tokens (B,1)
    int32, cache').

    ``vocab`` restricts the argmax to the first ``vocab`` logits: the head
    is padded, and a serving caller must never sample a padding id.
    ``page_size`` is the page the card's decode kernel walks a KV cache in
    (the recurrent state of the ssm family has none and ignores it).
    ``active`` gates the cache update per row (``ModelAPI.decode``).
    """

    def serve_step(params, cache, tokens, active=None):
        logits, cache = api.decode(params, cache, tokens, page_size=page_size, active=active)
        v = logits.shape[-1] if vocab is None else vocab
        nxt = torch.argmax(logits[:, -1, :v], dim=-1).to(torch.int32)[:, None]
        return nxt, cache

    return serve_step
