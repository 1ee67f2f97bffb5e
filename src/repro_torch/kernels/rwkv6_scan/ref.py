"""Plain PyTorch WKV6: the sequential recurrence of
``repro/kernels/rwkv6_scan/ref.py`` and ``repro/models/rwkv6.py`` ``_wkv6_seq``."""
from __future__ import annotations

from typing import Optional

import torch


def wkv6_ref(r, k, v, lw, u, state: Optional[torch.Tensor] = None):
    """r/k/v: (B, T, H, hd); lw: log-decay (B, T, H, hd), <= 0; u: (H, hd);
    state: (B, H, hd, hd) or None (zeros).

    Returns (y (B, T, H, hd) f32, final_state (B, H, hd, hd) f32), with

        S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T
        y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)

    State axes: [k-dim, v-dim].
    """
    b, t, h, hd = r.shape
    r, k, v, u = r.float(), k.float(), v.float(), u.float()
    w = torch.exp(lw.float())
    s = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device) if state is None \
        else state.float()
    ys = []
    for i in range(t):
        kv = k[:, i, :, :, None] * v[:, i, :, None, :]  # (B, H, hd, hd)
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, i], s + u[None, :, :, None] * kv))
        s = w[:, i, :, :, None] * s + kv
    return torch.stack(ys, dim=1), s
