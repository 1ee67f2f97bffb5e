"""Architecture config registry.

``get_config("qwen2.5-3b")`` returns the exact assigned config;
``list_archs()`` enumerates all ten. Arch ids use the assignment spelling.
"""
from __future__ import annotations

from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ModelConfig,
    ShapeSpec,
    applicable_shapes,
    skipped_shapes,
)

from repro_torch.configs.qwen2_5_3b import CONFIG as _qwen2_5_3b
from repro_torch.configs.internlm2_1_8b import CONFIG as _internlm2
from repro_torch.configs.smollm_360m import CONFIG as _smollm
from repro_torch.configs.qwen1_5_110b import CONFIG as _qwen110b
from repro_torch.configs.granite_moe_3b import CONFIG as _granite
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as _qwen2moe
from repro_torch.configs.rwkv6_7b import CONFIG as _rwkv6
from repro_torch.configs.zamba2_1_2b import CONFIG as _zamba2
from repro_torch.configs.qwen2_vl_7b import CONFIG as _qwen2vl
from repro_torch.configs.whisper_base import CONFIG as _whisper

_REGISTRY: dict[str, ModelConfig] = {
    c.name: c
    for c in (
        _qwen2_5_3b,
        _internlm2,
        _smollm,
        _qwen110b,
        _granite,
        _qwen2moe,
        _rwkv6,
        _zamba2,
        _qwen2vl,
        _whisper,
    )
}


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    return _REGISTRY[name]
