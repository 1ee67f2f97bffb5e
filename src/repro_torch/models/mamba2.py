"""Mamba2 (SSD) block, the state-space core of the zamba2 hybrid.

Mirrors repro/models/mamba2.py. Per head (P = head dim, N = state dim):

    S_t = exp(dt_t * A_h) * S_{t-1} + dt_t * x_t B_t^T        S: (P, N)
    y_t = S_t C_t + D_h x_t

with a causal depthwise conv in front of (x, B, C) and a gated RMSNorm
after. The scan is ``kernels.mamba2_scan``'s ``ssd_chunked``: its plain
version on the CPU, the hand-written kernel on the card. Decode state is
O(1): the conv tail (B, K-1, C) and the SSM state (B, H, P, N), both f32.
A training forward (``common.needs_grad``) takes ``ssd_train``: the same
kernel writing its chunk-entry states, and the chunked VJP in plain
PyTorch for the backward; it starts from zeros and takes no cache state,
since autograd keeps what the scan reads and a cache is written in place.

``apply`` casts the block's float leaves to ``cfg.compute_dtype`` as the
reference's ``constrain_tree`` does, ``A_log``, ``D``, ``dt_bias`` and the
conv weights included: at full width ``A = -exp(A_log)`` is a bf16 value.

Across a mesh (``launch.mesh``; the caller places the block at
``block_specs``) ``w_in``'s and ``conv_w``'s columns are split over
``MODEL``, but the z | xBC | dt and x | B | C boundaries need not fall on
a rank's columns: ``w_in``'s output is gathered whole before its split,
and the depthwise conv runs on whole channels and this rank's batch rows
(``launch.mesh.local_rows``; a training batch is split over the data
axes; the tail is replicated, ``cache_specs``). xs goes over heads at the
reference's site, and dt, ``A_log``, ``D`` and ``dt_bias`` reach B7 on the
same heads, B and C whole (each rank's gradient of them a partial sum
over its heads): each rank runs the scan on its own rows and heads
(``launch.mesh.local_heads``) with its own heads' SSM state. The gated
RMSNorm's mean over ``d_inner`` spans the ranks (an f32 reduction across
the mesh), and ``w_out``'s partial sums are added in f32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mamba2_scan import ssd_chunked, ssd_train
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.mesh import MODEL
from repro_torch.models import common
from repro_torch.models.common import ParamTree, matmul_f32


def dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    n_heads = d_in // cfg.ssm_head_dim
    return d_in, n_heads, cfg.ssm_state


def init_block(cfg: ModelConfig, g: torch.Generator, dtype) -> ParamTree:
    d = cfg.d_model
    d_in, nh, ns = dims(cfg)
    conv_dim = d_in + 2 * ns
    f32 = torch.float32
    return ParamTree(
        ln=torch.ones((d,), dtype=dtype),
        w_in=common.dense_init((d, 2 * d_in + 2 * ns + nh), g, dtype=dtype),
        conv_w=common.dense_init((cfg.ssm_conv, conv_dim), g, scale=1.0, dtype=f32),
        conv_b=torch.zeros((conv_dim,), dtype=f32),
        A_log=torch.zeros((nh,), dtype=f32),  # A = -exp(A_log) = -1
        D=torch.ones((nh,), dtype=f32),
        dt_bias=torch.full((nh,), -2.0, dtype=f32),  # softplus(-2) ~ 0.13
        norm_w=torch.ones((d_in,), dtype=dtype),
        w_out=common.dense_init((d_in, d), g, scale=1.0 / (2 * max(cfg.n_layers, 1)) ** 0.5,
                                dtype=dtype),
    )


def block_specs(cfg: ModelConfig) -> dict:
    """Compute-time (TP) specs for one Mamba2 block."""
    return {"ln": (None,), "w_in": (None, MODEL), "conv_w": (None, MODEL), "conv_b": (MODEL,),
            "A_log": (MODEL,), "D": (MODEL,), "dt_bias": (MODEL,), "norm_w": (MODEL,),
            "w_out": (MODEL, None)}


def _causal_conv(x, w, b, tail):
    """Depthwise causal conv. x: (B, T, C); w: (K, C); tail: (B, K-1, C) carry-in.

    Returns (y (B, T, C), new tail (B, K-1, C))."""
    k = w.shape[0]
    xp = torch.cat([tail, x], dim=1)  # (B, T+K-1, C)
    y = sum(xp[:, i: i + x.shape[1], :] * w[i][None, None, :] for i in range(k)) + b
    return y, xp[:, -(k - 1):, :] if k > 1 else torch.zeros_like(tail)


def init_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    d_in, nh, ns = dims(cfg)
    f32 = torch.float32
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, d_in + 2 * ns), dtype=f32, device=device),
        "ssm": torch.zeros((batch, nh, cfg.ssm_head_dim, ns), dtype=f32, device=device),
    }


def apply(p: dict, cfg: ModelConfig, x, state: Optional[dict] = None,
          active: Optional[torch.Tensor] = None):
    """Full mamba2 block (pre-norm, residual outside). p: the block's leaves
    as a dict (cast to the compute dtype here where the caller has not
    already); x: (B, T, D). Returns (out (B, T, D), new state).

    A given ``state`` (decode's, the cache's own tensors) is updated in
    place (the scan's kernel writes the SSM state over the old one) and its
    tensors are returned; without one the block starts from zeros. With a
    (B,) bool ``active`` beside the state, only its active rows are
    committed (the scan writes a new tensor first), so an inactive row
    keeps its conv tail and SSM state bit for bit. A training forward
    (the block's leaves requiring grad under grad mode) runs ``ssd_train``
    and refuses a given state."""
    p = {n: w.to(common.dt(cfg.compute_dtype)) if w.is_floating_point() else w
         for n, w in p.items()}
    b, t, _ = x.shape
    d_in, nh, ns = dims(cfg)
    hd = cfg.ssm_head_dim
    given = state is not None
    inplace = given and active is None
    xn = common.rms_norm(x, p["ln"], cfg.norm_eps)
    # gathered whole before the split: its boundaries cut the mesh's columns
    proj = meshlib.replicated_dim(matmul_f32(xn, p["w_in"]), -1)
    z, xbc, dt_raw = torch.split(proj, [d_in, d_in + 2 * ns, nh], dim=-1)
    # the conv on this rank's rows (a batch split over the data axes stays
    # so) and every channel, plain
    rows = meshlib.local_rows(xbc)
    if state is None:  # a zero tail, and a zero SSM state inside the scan
        state = {"conv": init_state(cfg, rows.shape[0], x.device)["conv"], "ssm": None}
    conv_out, conv_tail = _causal_conv(rows, *(meshlib.local_rows(p[n], like=xbc) for n in ("conv_w", "conv_b")),
                                       state["conv"])
    conv_out = F.silu(conv_out)
    xs, B, C = torch.split(conv_out, [d_in, ns, ns], dim=-1)
    if meshlib.is_dtensor(xbc):  # the rows as DTensors again, placed as xbc
        xs, B, C = (meshlib.from_local(v, xbc.device_mesh, xbc.placements, (b, t, v.shape[-1])) for v in (xs, B, C))
    # this rank's heads, plain: xs over heads (the reference's constraint),
    # and dt, A, D on the same heads; B and C whole, each rank's gradient
    # of them a partial sum over its heads
    xs = meshlib.to_heads(xs.reshape(b, t, nh, hd), 2)
    B, C = (meshlib.local_rows(v, like=xs) for v in (B, C))
    xs = meshlib.local(xs)
    dt = torch.logaddexp(meshlib.local_heads(dt_raw, 2) + meshlib.local_heads(p["dt_bias"], 0, like=xbc),
                         torch.zeros((), device=x.device))  # softplus
    A = -torch.exp(meshlib.local_heads(p["A_log"], 0, like=xbc)).float()
    D = meshlib.local_heads(p["D"], 0, like=xbc).float()
    if common.needs_grad(xs, dt, A, B, C, D):
        if given:
            raise ValueError("a training forward takes no cache state: the scan's inputs are kept "
                             "for the backward, and a cache is written in place")
        y, ssm_state = ssd_train(xs, dt, A, B, C, D)
    else:
        y, ssm_state = ssd_chunked(xs, dt, A, B, C, D, state["ssm"], inplace=inplace)
    y = meshlib.from_heads(y, 2, (b, t, nh, hd), like=xbc).reshape(b, t, d_in)
    # gated RMSNorm (mamba2 style): norm(y * silu(z))
    y = y * F.silu(z)
    var = (y * y).mean(dim=-1, keepdim=True)
    y = (y * torch.rsqrt(var + cfg.norm_eps) * p["norm_w"].float()).to(x.dtype)
    out = matmul_f32(y, p["w_out"]).to(x.dtype)
    if given:
        conv_tail = common.commit(state["conv"], conv_tail, active)
        if not inplace:
            ssm_state = common.commit(state["ssm"], ssm_state, active)
    return out, {"conv": conv_tail, "ssm": ssm_state}
