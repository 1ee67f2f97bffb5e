"""Qwen2-VL-7B text backbone (M-RoPE) (mirrors repro/models/vlm.py).

The vision tower is a stub, as in the reference: inputs are precomputed
patch/token embeddings (B, S, D) and (3, B, S) M-RoPE position ids
(temporal/height/width). The backbone is the dense transformer. Decode
continues in text space: the three M-RoPE channels advance together, which
is 1-D RoPE at ``lengths``, so decode is the transformer's.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as meshlib
from repro_torch.models import transformer


def init(cfg: ModelConfig, generator: torch.Generator, device=None) -> transformer.Transformer:
    return transformer.init(cfg, generator, device)


def forward(params, cfg: ModelConfig, embeds, mrope_positions, **kw):
    return transformer.forward(params, cfg, embeds=embeds, mrope_positions=mrope_positions, **kw)


def features(params, cfg: ModelConfig, embeds, mrope_positions, **kw):
    """The training trunk from ``embeds`` (B, S, D) and (3, B, S)
    ``mrope_positions``: ``transformer.features``'s (h, head weight).
    Across a mesh the positions, split over the batch axes as the
    embeds are, are gathered whole once: attention takes each rank's rows
    at its queries' own offsets (``attention._rope``)."""
    return transformer.features(params, cfg, embeds=embeds, mrope_positions=meshlib.whole(mrope_positions),
                                **kw)


def prefill(params, cfg: ModelConfig, embeds, mrope_positions, *, max_len: int, **kw):
    return transformer.prefill(params, cfg, embeds=embeds, mrope_positions=meshlib.whole(mrope_positions),
                               max_len=max_len, **kw)


def decode_step(params, cfg: ModelConfig, cache: dict, tokens, **kw):
    return transformer.decode_step(params, cfg, cache, tokens, **kw)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
    return transformer.init_cache(cfg, batch, max_len, dtype, device)


def param_specs(cfg: ModelConfig) -> dict:
    return transformer.param_specs(cfg)


def cache_specs(cfg: ModelConfig, model_axis: int = 16) -> dict:
    return transformer.cache_specs(cfg, model_axis)
