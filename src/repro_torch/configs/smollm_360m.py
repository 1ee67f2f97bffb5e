"""smollm-360m [dense] — llama-arch small, GQA. [hf:HuggingFaceTB/SmolLM-135M; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    qkv_bias=False,
    rope_theta=10_000.0,
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M; hf",
)
