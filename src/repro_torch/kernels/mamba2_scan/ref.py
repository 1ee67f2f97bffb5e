"""Plain PyTorch SSD: the sequential recurrence of
``repro/kernels/mamba2_scan/ref.py`` and ``repro/models/mamba2.py`` ``_ssd_seq``."""
from __future__ import annotations

from typing import Optional

import torch


def ssd_ref(x, dt, A, B, C, D, state: Optional[torch.Tensor] = None):
    """x: (b, T, H, P); dt: (b, T, H); A, D: (H,); B, C: (b, T, N);
    state: (b, H, P, N) or None (zeros).

    Returns (y (b, T, H, P) f32, final_state (b, H, P, N) f32), with

        S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T
        y_t = S_t C_t + D x_t
    """
    b, t, h, p = x.shape
    n = B.shape[-1]
    x, dt, A, B, C, D = (a.float() for a in (x, dt, A, B, C, D))
    s = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device) if state is None \
        else state.float()
    ys = []
    for i in range(t):
        da = torch.exp(dt[:, i] * A)  # (b, H), in (0, 1]
        s = s * da[..., None, None] + (dt[:, i, :, None] * x[:, i])[..., None] * B[:, i, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", s, C[:, i]))
    return torch.stack(ys, dim=1) + x * D[None, None, :, None], s
