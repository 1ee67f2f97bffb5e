"""Plain PyTorch SSD: the sequential recurrence of
``repro/kernels/mamba2_scan/ref.py`` and ``repro/models/mamba2.py`` ``_ssd_seq``."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build


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


CHUNK = 32  # steps per chunk in the kernel (kC in csrc/ssd.cu)
# Clusters of n prefill blocks an H100 keeps resident at once
# (cudaOccupancyMaxActiveClusters: two blocks on each of 132 SMs, less
# what a cluster's placement within one GPC loses at 4 and 8). The card
# tests hold the card to these counts.
RESIDENT_CLUSTERS = {1: 264, 2: 132, 4: 62, 8: 30}


def split_count(t: int, b: int, h: int) -> int:
    """How many blocks of a cluster the kernel splits each (b, h) sequence of
    ``t`` steps over (``build.split_count``): doubled up to 8 while every
    block keeps at least one whole chunk and the b * h clusters of the
    doubled count are all resident at once. A block waits at the cluster
    barrier for its cluster's others, so a cluster left for a second wave
    runs after a whole block's time: on the H100, zamba2-1.2b's prompt
    (T = 512, 64 heads) took 0.092 ms at 2 (one wave), 0.109 at 4 (two)
    and 0.098 at 8 (three; PERF.md, repro_torch.kernels.compare). A decode
    step (t = 1) gets 1; that prompt gets 2."""
    return build.split_count(-(-t // CHUNK), 1, lambda n: b * h <= RESIDENT_CLUSTERS[2 * n])


def split_chunks(t: int, n_split: int, j: int):
    """The chunks block ``j`` of ``n_split`` takes of the C = ceil(t / CHUNK)
    chunks (``build.chunk_span``)."""
    return build.chunk_span(-(-t // CHUNK), n_split, j)


def ssd_split_ref(x, dt, A, B, C, D, state: Optional[torch.Tensor] = None, n_split: int = 1):
    """The prefill kernel's algorithm in plain PyTorch, same arguments and
    result as ``ssd_ref``, with each sequence split over ``n_split`` blocks.

    Block j takes the chunks ``split_chunks`` gives it. From a zero state it
    forms, chunk by chunk in the closed form (cw the inclusive cumulative
    sum of dt A within the chunk, every exponent <= 0), its local outputs
    y_loc = ((C B^T) o G) x + exp(cw) o (C L^T) + D x and its local state
    L <- exp(cw_end) L + (x o exp(cw_end - cw) dt)^T B; its total decay is
    delta_j = exp(cwb_end), cwb the cumulative sum over all its steps. The
    state entering block j folds in block order, S = S0 then S = delta_i S
    + L_i for i < j; block j's outputs are y_loc + exp(cwb) o (C S^T). The
    final state is delta_last S + L_last of the last block. The card tests
    hold the kernel to it as a second oracle; nothing on the main path
    calls it.
    """
    b, t, h, p = x.shape
    n = B.shape[-1]
    x, dt, A, B, C, D = (a.float() for a in (x, dt, A, B, C, D))
    s_in = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device) if state is None \
        else state.float()
    y = torch.empty((b, t, h, p), dtype=torch.float32, device=x.device)
    carried = []  # (cwb per step, t0, t1) of each block, for the carry term
    for j in range(n_split):
        c0, c1 = split_chunks(t, n_split, j)
        t0, t1 = min(c0 * CHUNK, t), min(c1 * CHUNK, t)
        loc = torch.zeros_like(s_in)
        run = torch.zeros((b, h), dtype=torch.float32, device=x.device)
        cwb = []
        for s0 in range(t0, t1, CHUNK):
            s1 = min(s0 + CHUNK, t1)
            xc, dc, bc, cc = x[:, s0:s1], dt[:, s0:s1], B[:, s0:s1], C[:, s0:s1]
            cw = torch.cumsum(dc * A, dim=1)  # (b, n, H)
            gram = torch.einsum("btn,bsn->bts", cc, bc)
            seg = torch.exp(cw[:, :, None, :] - cw[:, None, :, :]) * dc[:, None, :, :]  # (b, t, s, H)
            tri = torch.tril(torch.ones(s1 - s0, s1 - s0, dtype=torch.bool, device=x.device))
            m = torch.where(tri[None, :, :, None], gram[..., None] * seg, 0.0)
            yc = torch.einsum("btsh,bshp->bthp", m, xc)
            yc = yc + torch.exp(cw)[..., None] * torch.einsum("btn,bhpn->bthp", cc, loc)
            y[:, s0:s1] = yc + D[None, None, :, None] * xc
            end = cw[:, -1]  # (b, H)
            w = torch.exp(end[:, None] - cw) * dc  # (b, n, H)
            loc = torch.exp(end)[..., None, None] * loc + torch.einsum("bthp,btn->bhpn", xc * w[..., None], bc)
            cwb.append(run[:, None] + cw)
            run = run + end
        carried.append((torch.cat(cwb, 1) if cwb else None, t0, t1, s_in))
        s_in = torch.exp(run)[..., None, None] * s_in + loc
    for cwb, t0, t1, s_blk in carried:
        if cwb is not None:
            y[:, t0:t1] += torch.exp(cwb)[..., None] * torch.einsum("btn,bhpn->bthp", C[:, t0:t1], s_blk)
    return y, s_in
