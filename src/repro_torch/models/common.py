"""Shared model primitives (mirrors repro/models/common.py).

* attention for prefill is chunked: a loop over KV blocks with an online
  softmax and f32 accumulators, so a long prompt never materializes an
  (Lq, Lk) matrix; ``AttentionFn`` is its training form, the reference's
  custom VJP: the forward keeps (q, k, v, out, lse), and the backward
  recomputes p for each key block from the lse;
* decode (Lq == 1) is a direct masked product over the cache;
* the losses: ``cross_entropy`` and the sequence-chunked ``fused_ce_loss``
  (each chunk's head product and CE under ``torch.utils.checkpoint``), and
  ``maybe_remat``, per-layer activation checkpointing;
* every matmul goes through :func:`matmul_f32`. The JAX einsums ask for
  f32 results (``preferred_element_type``); a product of bf16 inputs
  accumulated and returned in f32 is the f32 product of the upcast inputs,
  since bf16 products are exact in f32. Float32 matmuls must run in full
  f32: leave ``torch.backends.cuda.matmul.allow_tf32`` False (the default).

Across a mesh of cards (``launch.mesh``; the sharded engine's parameters
placed by ``shard_model_params``) the parameters are DTensors, and so is
the residual stream that meets them. Three primitives keep that boundary:
``matmul_f32`` lifts a plain operand beside a DTensor to a replicated one
and adds a split contraction's partial sums across the mesh at once, in
f32, so every later op sees whole values; ``rms_norm`` gathers a residual
sharded along the normalized dimension first; and the held casts
(``cast``) are keyed on the local shard's storage (a DTensor's own
``data_ptr()`` is 0) and, given a partition spec under an active mesh,
hold the weight placed at it, the reference's ``constrain_tree``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as _ckpt

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import mesh as meshlib

NEG_INF = -1e30

# ---------------------------------------------------------------------------
# dtype helpers


def dt(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}[name]


def needs_grad(*tensors) -> bool:
    """True in a training forward: grad mode on and an input that requires
    grad. The models then take the ops' ``autograd.Function``s
    (``AttentionFn``, ``WKV6Fn``, ``SSDFn``), whose forwards are the
    kernels on the card."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in f32, whatever the inputs' type. Across a mesh a plain
    operand meets a DTensor one replicated, and partial sums are added
    across the mesh in f32 (module docstring): each rank multiplies its
    local shards with the plain path's own op (``launch.mesh.local_matmul``),
    so a 1-card mesh runs exactly the plain path's kernels."""
    a, b = meshlib.common(a, b)
    fn = lambda x, y: torch.matmul(x.float(), y.float())
    return meshlib.reduced(meshlib.local_matmul(a, b, fn) if meshlib.is_dtensor(a) else fn(a, b))


def matmul_promoted(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as JAX computes it without ``preferred_element_type``: the
    f32 product, returned in the promoted type of the two inputs (a bf16
    activation times an f32 weight gives f32)."""
    return matmul_f32(a, b).to(torch.promote_types(a.dtype, b.dtype))


# ---------------------------------------------------------------------------
# parameter trees


def frozen(t: torch.Tensor, device=None) -> nn.Parameter:
    """``t`` on ``device`` as a parameter of a forward-only model."""
    return nn.Parameter(t.to(device), requires_grad=False)


def cast(owner: nn.Module, name: str, dtype, spec=None) -> torch.Tensor:
    """Parameter ``name`` of ``owner`` as ``dtype``, cast once and held.

    Casting a fixed tensor is deterministic, so the held cast is bit-equal
    to ``p.to(dtype)`` on every call. It is held on ``owner`` beside the
    parameter's identity, storage and version: an in-place load
    (``load_state_dict``, which bumps the version) or a move to another
    device casts anew. A non-float leaf, or ``dtype`` None or the leaf's
    own type, returns the parameter itself.

    ``spec``, a partition spec (``launch.mesh``), places a DTensor leaf at
    it under an active mesh, after the cast (the reference's
    ``constrain_tree``), and the placed leaf is held too; with no active
    mesh, or on a plain leaf, ``spec`` changes nothing. Without a spec, a
    leaf at its pooled storage layout (split over ``pool``) is gathered
    over that axis (``launch.mesh.unpooled``): a serving path reads it as
    stored, and the pool is storage only.

    A leaf that requires grad, under grad mode (a training forward), is
    cast fresh on every call and nothing is held: the cast is then a node
    of the graph, which carries the gradient back to the f32 leaf. Serving
    runs under ``torch.no_grad()`` on leaves that require none, and keeps
    its held casts.
    """
    p = getattr(owner, name)
    place = spec is not None and meshlib.is_dtensor(p) and meshlib.active_mesh() is not None
    unpool = spec is None and meshlib.pooled(p)
    recast = dtype is not None and p.is_floating_point() and p.dtype != dtype
    if not (recast or place or unpool):
        return p
    if p.requires_grad and torch.is_grad_enabled():
        t = p.to(dtype) if recast else p
        return meshlib.shard(t, *spec) if place else meshlib.unpooled(t)
    held = owner.__dict__.setdefault("_casts", {})
    key = (name, dtype if recast else None) + ((tuple(spec),) if place else ("unpooled",) if unpool else ())
    stamp = (id(p), meshlib.local(p).data_ptr(), p.device, p._version)
    entry = held.get(key)
    if entry is None or entry[0] != stamp:
        t = p.detach()
        if recast:
            t = t.to(dtype)
        if place:
            t = meshlib.shard(t, *spec)
        elif unpool:
            t = meshlib.unpooled(t)
        entry = held[key] = (stamp, t)
    return entry[1]


class ParamTree(nn.Module):
    """One node of the reference's parameter tree, under its names: leaves
    are frozen parameters, inner nodes ParamTrees, so ``state_dict`` keys
    are the reference's paths joined by dots."""

    def __init__(self, **children):
        super().__init__()
        for name, c in children.items():
            if isinstance(c, nn.Module):
                self.add_module(name, c)
            else:
                self.register_parameter(name, frozen(c))

    def tree(self, dtype=None, specs: dict = None) -> dict:
        """This node as nested dicts of tensors, float leaves cast to
        ``dtype`` and, under an active mesh, placed at ``specs`` (a nest of
        partition specs under the same names), as the reference's
        ``cast_tree``/``constrain_tree``; each cast once and held
        (:func:`cast`)."""
        sub = (lambda n: specs.get(n)) if specs is not None else (lambda n: None)
        out = {n: cast(self, n, dtype, sub(n)) for n, _ in self.named_parameters(recurse=False)}
        out.update({n: m.tree(dtype, sub(n)) for n, m in self.named_children()})
        return out


# ---------------------------------------------------------------------------
# initializers (drawn on the CPU from an explicit generator; with none, as
# ``ModelAPI.init`` passes for the meta device, nothing is drawn)


def _truncated_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard normal truncated to [-2, 2], by inverse-CDF sampling."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    x = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (1.0 - 2.0 * lo)) - 1.0)
    return x.clamp(-2.0, 2.0)


def dense_init(shape, generator: torch.Generator, in_axis: int = 0, scale: float = 1.0,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init."""
    if generator is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    std = scale / math.sqrt(shape[in_axis])
    return (_truncated_normal(shape, generator) * std).to(dtype)


def embed_init(shape, generator: torch.Generator, dtype=torch.float32) -> torch.Tensor:
    if generator is None:
        return torch.empty(shape, dtype=dtype, device="meta")
    return (torch.randn(shape, generator=generator, dtype=torch.float32) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last dimension; a DTensor sharded along it is
    gathered first, so the mean is one rank's, never a partial one."""
    x = meshlib.replicated_dim(x, -1)
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim))


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, H, L, D); positions: (B, L) int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (D/2,)
    ang = positions[:, None, :, None].float() * freqs  # (B,1,L,D/2)
    cos = torch.cat([torch.cos(ang)] * 2, dim=-1)
    sin = torch.cat([torch.sin(ang)] * 2, dim=-1)
    xf = x.float()
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float, sections) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE. x: (B, H, L, D); positions: (3, B, L) int
    [t, h, w]; ``sections`` sum to D/2: the first sections[0] frequencies
    take the t position, the next the h, the rest the w. With three equal
    channels the angles are apply_rope's products, so the result is
    bit-equal to it."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (D/2,)
    sec = torch.cat([torch.full((s,), i, dtype=torch.long, device=x.device)
                     for i, s in enumerate(sections)])  # (D/2,)
    pos_sel = positions.float()[sec].permute(1, 2, 0)  # (B, L, D/2)
    ang = pos_sel[:, None, :, :] * freqs  # (B,1,L,D/2)
    cos = torch.cat([torch.cos(ang)] * 2, dim=-1)
    sin = torch.cat([torch.sin(ang)] * 2, dim=-1)
    xf = x.float()
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)


# ---------------------------------------------------------------------------
# attention


def _expand_gqa(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, Hq, L, D) -> (B, Hkv, G, L, D)."""
    b, hq, l, d = q.shape
    return q.reshape(b, n_kv, hq // n_kv, l, d)


def _kv_blocks(k: torch.Tensor, v: torch.Tensor, block_k: int):
    """(B,Hkv,Lk,D) k/v -> (nb,B,Hkv,block,D) stacks, zero-padded."""
    b, hkv, lk, d = k.shape
    nb = max(1, -(-lk // block_k))
    pad = nb * block_k - lk
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    kb = k.reshape(b, hkv, nb, block_k, d).permute(2, 0, 1, 3, 4)
    vb = v.reshape(b, hkv, nb, block_k, d).permute(2, 0, 1, 3, 4)
    return kb, vb, nb


def _block_scores(qg, kblk, iblk, *, scale, block_k, lk, lq, q_offset, causal, bidirectional):
    """Masked f32 scores for one k-block: (B,Hkv,G,Lq,block), the mask an
    additive (Lq, block) bias as in the reference."""
    dev = qg.device
    kv_pos = iblk * block_k + torch.arange(block_k, device=dev)
    s = matmul_f32(qg, kblk[:, :, None].transpose(-1, -2)) * scale
    valid = kv_pos < lk
    if causal and not bidirectional:
        q_pos = q_offset + torch.arange(lq, device=dev)
        valid = valid[None, :] & (kv_pos[None, :] <= q_pos[:, None])  # (Lq, block)
    bias = torch.where(valid, 0.0, NEG_INF).to(torch.float32)
    return s + bias


def _attention_fwd_impl(q, k, v, causal: bool, q_offset: int, block_k: int, bidirectional: bool):
    """The online-softmax forward: (out (B, Hq, Lq, D) in q.dtype, lse
    (B, Hkv, G, Lq) f32), lse = m + log(l), 0 where l = 0."""
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    qg = _expand_gqa(q, hkv)  # (B,Hkv,G,Lq,D)
    g = qg.shape[2]
    kb, vb, nb = _kv_blocks(k, v, block_k)
    m = torch.full((b, hkv, g, lq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g, lq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, lq, d), dtype=torch.float32, device=q.device)
    for i in range(nb):
        s = _block_scores(
            qg, kb[i], i, scale=scale, block_k=block_k, lk=lk, lq=lq,
            q_offset=q_offset, causal=causal, bidirectional=bidirectional,
        )
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + matmul_f32(p.to(vb.dtype), vb[i][:, :, None])
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    # flash-style softmax stats: 0 for a row with l = 0, so the backward's
    # exp(s - lse) stays 0 there (s is NEG_INF) instead of nan
    lse = torch.where(l > 0, m + torch.log(torch.clamp_min(l, 1e-30)), 0.0)
    return out.reshape(b, hq, lq, d).to(q.dtype), lse


def attention_chunked(q, k, v, *, causal: bool = True, q_offset: int = 0,
                      block_k: int = 1024, bidirectional: bool = False) -> torch.Tensor:
    """Online-softmax attention, O(L * block_k) memory.

    q: (B, Hq, Lq, D); k, v: (B, Hkv, Lk, D). GQA via Hq % Hkv == 0.
    Returns (B, Hq, Lq, D) in q.dtype. Autograd differentiates it op by op
    (holding every block's residuals); training takes ``attention_train``.
    """
    return _attention_fwd_impl(q, k, v, causal, q_offset, block_k, bidirectional)[0]


def _contract_gq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum("bhgqk,bhgqd->bhkd", a, b) in f32: one product over the
    (g, q) rows, the sum over both axes at once."""
    bb, h, g, lq, n = a.shape
    a2 = a.permute(0, 1, 4, 2, 3).reshape(bb, h, n, g * lq)
    return matmul_f32(a2, b.reshape(bb, h, g * lq, b.shape[-1]))


def _attention_bwd(causal: bool, q_offset: int, block_k: int, bidirectional: bool,
                   q, k, v, out, lse, dout):
    """Flash-attention backward (the reference's ``_attention_bwd``): p
    recomputed per key block from (q, k, lse) against every query row, the
    products' operands in the compute dtype and their sums in f32."""
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    qg = _expand_gqa(q, hkv)
    g = qg.shape[2]
    kb, vb, nb = _kv_blocks(k, v, block_k)
    do = _expand_gqa(dout, hkv)  # (B,Hkv,G,Lq,D), compute dtype
    og = _expand_gqa(out, hkv)
    delta = (do.float() * og.float()).sum(-1)  # (B,Hkv,G,Lq)
    dq = torch.zeros((b, hkv, g, lq, d), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for i in range(nb):
        kblk, vblk = kb[i], vb[i]
        s = _block_scores(
            qg, kblk, i, scale=scale, block_k=block_k, lk=lk, lq=lq,
            q_offset=q_offset, causal=causal, bidirectional=bidirectional,
        )
        p = torch.exp(s - lse[..., None])  # exact probs (B,Hkv,G,Lq,block)
        dvs.append(_contract_gq(p.to(v.dtype), do))
        dp = matmul_f32(do, vblk[:, :, None].transpose(-1, -2))
        ds = (p * (dp - delta[..., None]) * scale).to(k.dtype)
        dq = dq + matmul_f32(ds, kblk[:, :, None])
        dks.append(_contract_gq(ds, qg))
    dk = torch.cat(dks, dim=2)[:, :, :lk]
    dv = torch.cat(dvs, dim=2)[:, :, :lk]
    return dq.reshape(b, hq, lq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class AttentionFn(torch.autograd.Function):
    """Attention with the reference's flash-style custom VJP
    (``_attention_core``): the forward saves (q, k, v, out, lse) and no
    per-block residual; the backward recomputes p for each key block of
    ``block_k`` from the lse (``_attention_bwd``).

    The forward follows the tensors' device: on the card it is the flash
    kernel (B5), asked for its softmax stats (its key tiles are its own,
    64 rows), and so on meta inside a cost walk (``build.kernel_route``);
    on the CPU the online-softmax forward of ``attention_chunked``. Its forward runs with grad mode off, so the
    kernel's wrapper takes it."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_offset: int, block_k: int, bidirectional: bool):
        b, hq, lq, _ = q.shape
        hkv = k.shape[1]
        if build.kernel_route(q):
            out, lse = flash_attention(q, k, v, causal=causal and not bidirectional,
                                       lk_valid=k.shape[2], q_offset=q_offset, return_lse=True)
            lse = lse.reshape(b, hkv, hq // hkv, lq)
        else:
            out, lse = _attention_fwd_impl(q, k, v, causal, q_offset, block_k, bidirectional)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_offset, block_k, bidirectional)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _attention_bwd(*ctx.args, q, k, v, out, lse, dout)
        return dq, dk, dv, None, None, None, None


def attention_train(q, k, v, *, causal: bool = True, q_offset: int = 0, block_k: int = 1024,
                    bidirectional: bool = False) -> torch.Tensor:
    """``attention_chunked``'s result through ``AttentionFn``: the
    attention of a training forward. Returns (B, Hq, Lq, D) in q.dtype."""
    return AttentionFn.apply(q, k, v, causal, q_offset, block_k, bidirectional)


def attention_decode(q, k, v, kv_length) -> torch.Tensor:
    """Single-position attention over a (possibly partially filled) cache.

    q: (B, Hq, 1, D); k, v: (B, Hkv, S, D); kv_length: (B,) valid lengths.
    """
    b, hq, lq, d = q.shape
    hkv, s_len = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(d)
    qg = _expand_gqa(q, hkv)
    s = matmul_f32(qg, k[:, :, None].transpose(-1, -2)) * scale  # (B,Hkv,G,1,S)
    kv_length = torch.as_tensor(kv_length, device=q.device).reshape(-1).expand(b)
    mask = torch.arange(s_len, device=q.device)[None, :] < kv_length[:, None]  # (B, S)
    s = torch.where(mask[:, None, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    o = matmul_f32(p.to(v.dtype), v[:, :, None])
    o = o / torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    return o.reshape(b, hq, lq, d).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP


def swiglu(x, w_gate, w_up, w_down) -> torch.Tensor:
    g = matmul_f32(x, w_gate)
    u = matmul_f32(x, w_up)
    h = (F.silu(g) * u).to(x.dtype)
    return matmul_f32(h, w_down).to(x.dtype)


def gelu_mlp(x, w_in, b_in, w_out, b_out) -> torch.Tensor:
    """Whisper's MLP; ``jax.nn.gelu`` defaults to the tanh approximation."""
    h = matmul_f32(x, w_in) + b_in
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return (matmul_f32(h, w_out) + b_out).to(x.dtype)


# ---------------------------------------------------------------------------
# losses


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab_size: int,
                  z_coef: float = 1e-4):
    """Mean CE over labels >= 0; logits padding beyond vocab_size is masked.

    logits: (B, S, Vp) any float dtype; labels: (B, S) int with -1 = ignore.
    Returns (loss, metrics dict), every value an f32 tensor.
    """
    vp = logits.shape[-1]
    lf = logits.float()
    if vp > vocab_size:
        pad_mask = torch.arange(vp, device=lf.device) >= vocab_size
        lf = torch.where(pad_mask[None, None, :], NEG_INF, lf)
    lse = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, labels.long().clamp_min(0)[..., None])[..., 0]
    nll = lse - gold
    mask = (labels >= 0).float()
    denom = torch.clamp_min(mask.sum(), 1.0)
    loss = (nll * mask).sum() / denom
    zloss = z_coef * ((lse * mask) ** 2).sum() / denom
    # accuracy as gold == max, as the reference (no argmax)
    metrics = {
        "loss": loss,
        "zloss": zloss,
        "tokens": mask.sum(),
        "accuracy": ((gold >= lf.amax(-1)) * mask).sum() / denom,
    }
    return loss + zloss, metrics


def _ce_chunk(hc, lc, w, vocab_bias):
    """One sequence chunk of ``fused_ce_loss``: (nll, z, tokens, correct)
    sums. Across a mesh the chunk's logits are gathered along the
    vocabulary first (the label lookup is exact on whole rows)."""
    logits = meshlib.replicated_dim(matmul_f32(hc, w.to(hc.dtype)), -1) + vocab_bias
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lc.long().clamp_min(0)[..., None])[..., 0]
    msk = (lc >= 0).float()
    return (((lse - gold) * msk).sum(), ((lse * msk) ** 2).sum(), msk.sum(),
            ((gold >= logits.amax(-1)) * msk).sum())


def fused_ce_loss(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, vocab_size: int, *,
                  chunk: int = 1024, z_coef: float = 1e-4):
    """Sequence-chunked fused lm_head + cross-entropy.

    Never materializes the full (B, S, Vp) logits: the head product and the
    CE run one chunk of the sequence at a time, each under
    ``torch.utils.checkpoint`` (the backward recomputes the chunk's logits),
    as the reference's chunk body runs under ``jax.checkpoint``. The
    vocabulary's padding is masked with an additive -1e30. h: (B, S, D)
    post-final-norm; w: (D, Vp), cast to h's dtype in each chunk; labels:
    (B, S) int with -1 = ignore. Returns (loss, metrics) like
    ``cross_entropy``.
    """
    h = meshlib.replicated_dim(h, 1)  # across a mesh: a sequence split over the cards gathered
    b, s, d = h.shape
    vp = w.shape[-1]
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    nc = (s + pad) // chunk
    hs = h.reshape(b, nc, chunk, d)
    ls = labels.reshape(b, nc, chunk)
    vocab_bias = torch.where(torch.arange(vp, device=h.device) < vocab_size, 0.0, NEG_INF).float()
    zero = torch.zeros((), dtype=torch.float32, device=h.device)
    vocab_bias, zero = meshlib.like(vocab_bias, h), meshlib.like(zero, h)  # across a mesh: replicated
    nll, zz, ntok, ncorr = zero, zero, zero, zero
    for i in range(nc):
        a, z, t, c = _ckpt.checkpoint(_ce_chunk, hs[:, i], ls[:, i], w, vocab_bias,
                                      use_reentrant=False, preserve_rng_state=False)
        nll, zz, ntok, ncorr = nll + a, zz + z, ntok + t, ncorr + c
    denom = torch.clamp_min(ntok, 1.0)
    loss = nll / denom
    zloss = z_coef * zz / denom
    metrics = {"loss": loss, "zloss": zloss, "tokens": ntok, "accuracy": ncorr / denom}
    return loss + zloss, metrics


# ---------------------------------------------------------------------------
# misc


def maybe_remat(fn, enabled: bool, policy: str = "nothing"):
    """Per-layer activation checkpointing (``torch.utils.checkpoint``,
    non-reentrant).

    policy="nothing": save only the block's inputs, recompute the rest in
    the backward (minimum memory); policy="dots": also save the outputs of
    the 2-D weight products (``aten.mm``), recompute everything else, as
    the reference's ``dots_with_no_batch_dims_saveable``. The blocks hold
    no random ops, so no RNG state is kept.
    """
    if not enabled:
        return fn
    if policy == "nothing":
        return lambda *args: _ckpt.checkpoint(_under_active_mesh(fn), *args, use_reentrant=False,
                                              preserve_rng_state=False)
    if policy == "dots":
        def save_dots(ctx, op, *args, **kwargs):
            if op is torch.ops.aten.mm.default:
                return _ckpt.CheckpointPolicy.MUST_SAVE
            return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE

        def contexts():
            return _ckpt.create_selective_checkpoint_contexts(save_dots)

        return lambda *args: _ckpt.checkpoint(_under_active_mesh(fn), *args, use_reentrant=False,
                                              preserve_rng_state=False, context_fn=contexts)
    raise ValueError(f"remat policy {policy!r}: 'nothing' or 'dots'")


def _under_active_mesh(fn):
    """``fn`` run under the mesh active at this call (``launch.mesh``): the
    backward's recompute of a checkpointed block may run on autograd's
    device thread, where the caller's thread-local active mesh is not set,
    and must place its tensors as the forward did."""
    mesh = meshlib.active_mesh()

    def body(*args):
        with meshlib.activate(mesh):
            return fn(*args)

    return body


def commit(dst: torch.Tensor, new: torch.Tensor, active=None) -> torch.Tensor:
    """``dst[:] = new`` in place, batch on axis 0; with a (B,) bool
    ``active``, only the rows where it is True, the others bit-unchanged.
    Returns ``dst``."""
    if active is None:
        return dst.copy_(new)
    return dst.copy_(torch.where(active.reshape((-1,) + (1,) * (dst.ndim - 1)), new, dst))


def advance(lengths: torch.Tensor, active=None) -> torch.Tensor:
    """The lengths after one decode: +1 on every row, or on the rows where
    a given (B,) bool ``active`` is True."""
    return lengths + 1 if active is None else lengths + active.to(lengths.dtype)


def causal_positions(batch: int, seq: int, device=None) -> torch.Tensor:
    return torch.arange(seq, dtype=torch.int32, device=device)[None, :].expand(batch, seq)


def sinusoidal_positions(length: int, d_model: int, device=None) -> torch.Tensor:
    """(length, d_model) f32: sin at the even channels, cos at the odd."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d_model))
    pe = torch.zeros((length, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe
