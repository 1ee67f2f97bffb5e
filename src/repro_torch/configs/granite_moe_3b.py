"""granite-moe-3b-a800m [moe] — 40 routed experts, top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

40 % 16 != 0 so EP over the 16-way model axis is off; expert FFN hidden dim is
sharded instead (TP-for-MoE; DESIGN.md §3).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    grad_accum=4,
    moe_group=1024,  # §Perf hillclimb: capacity state is O(k t^2)/group
    n_experts=40,
    n_shared_experts=0,
    top_k=8,
    moe_d_ff=512,
    rope_theta=10_000.0,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)
