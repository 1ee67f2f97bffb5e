"""whisper-base [audio] — enc-dec, conv frontend (stubbed).
[arXiv:2212.04356; unverified]

Backbone only: input_specs() provides precomputed mel-frame embeddings
(the conv1d frontend is a stub per the assignment).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,  # decoder layers
    n_encoder_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    n_audio_frames=1500,
    rope_theta=0.0,  # learned/sinusoidal positions, no RoPE
    source="arXiv:2212.04356; unverified",
)
