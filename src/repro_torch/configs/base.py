"""Config system: architecture configs + input-shape specs.

Every assigned architecture is a ``ModelConfig`` (one module per arch under
``repro.configs``). The four assigned input shapes are ``ShapeSpec`` entries in
``SHAPES``. ``applicable_shapes(cfg)`` encodes the per-family skip rules from
the assignment (see DESIGN.md §Arch-applicability).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input shape (seq_len x global_batch)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description. Covers dense / moe / ssm / hybrid / vlm / audio.

    Only the fields relevant to ``family`` are honored by the model builders.
    """

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    # attention details
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    router_aux_coef: float = 0.001
    capacity_factor: float = 1.25

    # SSM (rwkv6 / mamba2 / zamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2
    # hybrid (zamba2): a shared attention block applied every k ssm layers
    shared_attn_every: int = 0

    # vlm (qwen2-vl): M-RoPE section split of head_dim/2
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)

    # audio (whisper): encoder-decoder
    n_encoder_layers: int = 0
    n_audio_frames: int = 1_500

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # runtime feature flags (the paper's technique; see core/)
    pooling_cluster: int = 1  # shared-L2 analogue: ZeRO-style weight pooling over k
    kv_page_size: int = 128  # tokens per KV page (pagetable/tiering granularity)
    remat: bool = True
    remat_policy: str = "nothing"  # "nothing" | "dots" (see common.maybe_remat)
    sp_activations: bool = False  # shard the residual stream's seq dim over MODEL
    attn_block_k: int = 256  # k-block for the online-softmax reference attention
    grad_accum: int = 1  # microbatches per step: remat stacks scale as 1/A
    moe_dispatch: str = "einsum"  # "einsum" (GShard one-hot) | "sort" (no one-hot)
    remat_every: int = 1  # checkpoint every k layers: saved stack scales 1/k
    moe_group: int = 2048  # max tokens per routing group: dispatch/combine
    # state is O(1.25*k*t^2/1) per group, so long-sequence cells re-group

    source: str = ""  # provenance tag from the assignment table

    # ------------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        # padded for TP divisibility + lane alignment; CE masks the padding.
        return _round_up(self.vocab_size, 256)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs autoregress (whisper via its decoder)

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def n_params(self) -> int:
        """Approximate parameter count (embedding + blocks), for roofline."""
        d, f, v = self.d_model, self.d_ff, self.padded_vocab
        kv_dim = self.n_kv_heads * self.head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "vlm"):
            per = d * (d + 2 * kv_dim) + d * d + 3 * d * f + 2 * d
            return emb + self.n_layers * per
        if self.family == "moe":
            attn = d * (d + 2 * kv_dim) + d * d
            routed = self.n_experts * 3 * d * self.moe_d_ff
            shared = 3 * d * self.moe_d_ff * self.n_shared_experts
            router = d * self.n_experts
            return emb + self.n_layers * (attn + routed + shared + router + 2 * d)
        if self.family == "ssm":  # rwkv6
            att = 4 * d * d + 6 * d * 32 + d  # r,k,v,o + lora-ish mixers
            ffn = 2 * d * f
            return emb + self.n_layers * (att + ffn + 2 * d)
        if self.family == "hybrid":  # zamba2
            d_in = self.ssm_expand * d
            per = d * (2 * d_in + 2 * self.ssm_state) + d_in * d
            n_shared = 1
            shared_attn = n_shared * (4 * (2 * d) * (2 * d))
            return emb + self.n_layers * per + shared_attn
        if self.family == "audio":
            dec = self.n_layers * (4 * d * d + 2 * d * f + 4 * d * d)
            enc = self.n_encoder_layers * (4 * d * d + 2 * d * f)
            return emb + dec + enc
        raise ValueError(self.family)

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed top_k active)."""
        if self.family != "moe":
            return self.n_params()
        d = self.d_model
        kv_dim = self.n_kv_heads * self.head_dim
        attn = d * (d + 2 * kv_dim) + d * d
        act = (self.top_k + self.n_shared_experts) * 3 * d * self.moe_d_ff
        router = d * self.n_experts
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        return emb + self.n_layers * (attn + act + router + 2 * d)

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests.

        compute_dtype falls back to float32: the XLA CPU runtime cannot
        EXECUTE bf16xbf16 dots (it can compile them — the dry-run keeps
        bf16, which is what the TPU target runs).
        """
        heads = min(self.n_heads, 4)
        kv = max(1, min(self.n_kv_heads, heads))
        while heads % kv:
            kv -= 1
        return dataclasses.replace(
            self,
            compute_dtype="float32",
            n_layers=2,
            d_model=64,
            n_heads=heads,
            n_kv_heads=kv,
            d_ff=128,
            vocab_size=512,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_d_ff=64 if self.moe_d_ff else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state or self.family == "ssm" else self.ssm_head_dim,
            shared_attn_every=2 if self.shared_attn_every else 0,
            n_encoder_layers=2 if self.n_encoder_layers else 0,
            n_audio_frames=16 if self.n_encoder_layers else self.n_audio_frames,
            mrope_sections=(4, 2, 2),
            kv_page_size=16,
        )


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """Assigned-shape cells for this arch, with the assignment's skip rules."""
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        shapes.append("long_500k")  # full-attention archs skip long_500k
    return shapes


def skipped_shapes(cfg: ModelConfig) -> dict[str, str]:
    out = {}
    if not cfg.sub_quadratic:
        out["long_500k"] = (
            "full-attention arch: 500k context requires sub-quadratic attention "
            "(assignment: run long_500k only for SSM/hybrid/linear-attn)"
        )
    return out
