"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; hf]

The shared attention block (one param set applied at multiple depths) is the
paper's shared-structure idea in model form; KV tiering applies to the shared
attention KV only. Runs long_500k (sub-quadratic backbone).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    grad_accum=4,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    shared_attn_every=6,
    rope_theta=10_000.0,
    source="arXiv:2411.15242; hf",
)
