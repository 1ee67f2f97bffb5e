"""qwen2-moe-a2.7b [moe] — 60 routed experts top-4 + 4 shared.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    grad_accum=4,
    moe_group=1024,  # §Perf hillclimb: capacity state is O(k t^2)/group
    pooling_cluster=4,
    qkv_bias=True,
    n_experts=60,
    n_shared_experts=4,
    top_k=4,
    moe_d_ff=1408,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B; hf",
)
