"""Model API for the port (mirrors repro/models/api.py, serving subset).

Ported families: dense (``transformer``), ssm (``rwkv6``) and hybrid
(``zamba2``). The others (moe, vlm, audio) raise ``NotImplementedError``
naming their ROADMAP item (A8).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import rwkv6, transformer, zamba2

_PORTED = {"dense": transformer, "ssm": rwkv6, "hybrid": zamba2}


@dataclasses.dataclass
class ModelAPI:
    cfg: ModelConfig

    def __post_init__(self):
        if self.cfg.family not in _PORTED:
            raise NotImplementedError(
                f"family {self.cfg.family!r} ({self.cfg.name}) is not ported yet: ROADMAP A8"
            )

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
        return _PORTED[self.family].prefill(params, self.cfg, batch["tokens"], max_len=max_len)

    def decode(self, params, cache: dict, tokens, *, page_size: int = 16, active=None):
        """One decode step, the cache updated in place; a given (B,) bool
        ``active`` leaves every cache leaf of its False rows as it was."""
        return _PORTED[self.family].decode_step(params, self.cfg, cache, tokens,
                                                page_size=page_size, active=active)


def get_model(cfg: ModelConfig) -> ModelAPI:
    return ModelAPI(cfg)


def kernel_launches(cfg: ModelConfig, prefills: int, decodes: int) -> dict:
    """The model kernels' launches on the card over ``prefills`` prefill and
    ``decodes`` decode dispatches: attention once per dense layer or per
    application of zamba2's shared block (flash in prefill, paged in
    decode), and a scan once per recurrent layer in either."""
    n = cfg.n_layers
    if cfg.family == "dense":
        return {"flash_attention": n * prefills, "paged_attention": n * decodes, "wkv6": 0, "ssd": 0}
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
