"""rwkv6-7b [ssm] — Finch, attention-free, data-dependent decay.
[arXiv:2404.05892; hf]

Attention-free: KV tiering / prefix sharing inapplicable (O(1) state);
parameter pooling + embedding-row tiering apply. Runs long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,  # wkv heads = d_model / ssm_head_dim
    n_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    grad_accum=8,
    pooling_cluster=4,  # §Perf: pooled (ZeRO) storage pins grads/opt math
    # to the sharded layout — without it GSPMD replicates the (L,D,D) f32
    # AdamW pipeline (30 GiB/chip); with it the cell fits at 15.7 GiB.
    ssm_head_dim=64,
    rope_theta=0.0,  # no RoPE (attention-free)
    source="arXiv:2404.05892; hf",
)
