"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution. [arXiv:2409.12191; hf]

Backbone only: the vision tower is a stub; input_specs() provides precomputed
patch embeddings + (3, B, S) M-RoPE position ids, per the assignment.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    grad_accum=8,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    source="arXiv:2409.12191; hf",
)
