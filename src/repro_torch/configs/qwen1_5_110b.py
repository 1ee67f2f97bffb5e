"""qwen1.5-110b [dense] — QKV bias, GQA. [hf:Qwen/Qwen1.5-0.5B; hf]

The cluster-weight-pooling flagship: at TP=16, full f32 optimizer state does
not fit one replica's HBM without pooling (see core/pooling.py).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    pooling_cluster=16,
    sp_activations=True,  # seq-shard residuals: 80 layers of saved h fit HBM
    source="hf:Qwen/Qwen1.5-0.5B; hf",
)
