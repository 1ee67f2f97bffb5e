"""Plain PyTorch SSD: the sequential recurrence of
``repro/kernels/mamba2_scan/ref.py`` and ``repro/models/mamba2.py`` ``_ssd_seq``."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build


def ssd_ref(x, dt, A, B, C, D, state: Optional[torch.Tensor] = None, *, return_states: bool = False):
    """x: (b, T, H, P); dt: (b, T, H); A, D: (H,); B, C: (b, T, N);
    state: (b, H, P, N) or None (zeros).

    Returns (y (b, T, H, P) f32, final_state (b, H, P, N) f32), with

        S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T
        y_t = S_t C_t + D x_t

    With ``return_states`` also the state entering each chunk of ``CHUNK``
    steps, (b, H, C, P, N) f32 with C = ceil(T / CHUNK): the kernel's
    chunk-entry states, which ``ssd_vjp`` reads.
    """
    b, t, h, p = x.shape
    n = B.shape[-1]
    x, dt, A, B, C, D = (a.float() for a in (x, dt, A, B, C, D))
    s = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device) if state is None \
        else state.float()
    ys, states = [], []
    for i in range(t):
        if i % CHUNK == 0:
            states.append(s)
        da = torch.exp(dt[:, i] * A)  # (b, H), in (0, 1]
        s = s * da[..., None, None] + (dt[:, i, :, None] * x[:, i])[..., None] * B[:, i, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", s, C[:, i]))
    y = torch.stack(ys, dim=1) + x * D[None, None, :, None]
    if return_states:
        return y, s, torch.stack(states, dim=2)
    return y, s


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



def _chunk_vjp(x, dt, A, B, C, D, s, dy, ds_out):
    """The VJP of one chunk of the closed form, by hand, batched over a
    group of G chunks: x, dy (b, G, n, H, P); dt (b, G, n, H); A and D
    (H,); B and C (b, G, n, N); s and ds_out (b, G, H, P, N), the state
    entering each chunk and the cotangent of the state leaving it -> (dx,
    ddt, dA, dB, dC, dD).

    Forward, per chunk (cw the inclusive cumulative sum of dt A; every
    exponent <= 0):

        M[t,s] = (C_t . B_s) exp(cw_t - cw_s) dt_s   (s <= t: y_t reads S_t)
        y_t    = sum_s M[t,s] x_s + exp(cw_t) S C_t + D x_t
        S'     = exp(cw_end) S + sum_s exp(cw_end - cw_s) dt_s x_s B_s^T

    The gradient of each step's log decay dt_q A is summed directly over
    the terms whose exponent holds it (pairs with s < q <= t, outputs at
    and after q, the state's decay, state updates before q), never as a
    difference of cumulative sums, which cancels to some 3e-4 of dA's
    scale when the chunk's decays are strong."""
    n = x.shape[2]
    cw = torch.cumsum(dt * A, dim=2)  # (b, G, n, H)
    tri = torch.tril(torch.ones(n, n, dtype=torch.bool, device=x.device))
    seg = torch.exp(torch.where(tri[:, :, None], cw[:, :, :, None] - cw[:, :, None], -torch.inf))
    gram = torch.einsum("bgtn,bgsn->bgts", C, B)
    gs = gram[..., None] * seg  # (b, G, t, s, H)
    m = gs * dt[:, :, None]
    end = cw[:, :, -1:]  # (b, G, 1, H)
    ecw, eend = torch.exp(cw), torch.exp(end - cw)
    w = eend * dt
    dm = torch.einsum("bgthp,bgshp->bgtsh", dy, x) * tri[:, :, None]
    sc_dy = torch.einsum("bgthp,bghpn->bgthn", dy, s)  # dy_t S, (b, G, t, H, N)
    xb_ds = torch.einsum("bgshp,bghpn->bgshn", x, ds_out)  # x_s dS', (b, G, s, H, N)
    dx = torch.einsum("bgtsh,bgthp->bgshp", m, dy) + D[:, None] * dy
    dx = dx + w[..., None] * torch.einsum("bghpn,bgsn->bgshp", ds_out, B)
    dgram = (dm * seg * dt[:, :, None]).sum(-1)  # (b, G, t, s)
    dC = torch.einsum("bgts,bgsn->bgtn", dgram, B) + torch.einsum("bgth,bgthn->bgtn", ecw, sc_dy)
    dB = torch.einsum("bgts,bgtn->bgsn", dgram, C) + torch.einsum("bgsh,bgshn->bgsn", w, xb_ds)
    dD = (dy * x).sum((0, 1, 2, 4))
    g_upd = (xb_ds * B[:, :, :, None]).sum(-1)  # <dS', x_s B_s^T>, (b, G, s, H)
    ddt = (dm * gs).sum(2) + eend * g_upd
    # d(dt_q A): pairs (t, s) with s < q <= t; outputs t >= q through
    # exp(cw_t); the state's decay; state updates s < q through exp(cw_end - cw_s)
    wt = (dm * m).permute(0, 1, 4, 2, 3)  # (b, G, H, t, s)
    dl = (wt.reshape(*wt.shape[:3], n * n) @ _straddle(n, x.device)).permute(0, 1, 3, 2)
    v = ecw * (sc_dy * C[:, :, :, None]).sum(-1)
    dl = dl + torch.flip(torch.cumsum(torch.flip(v, (2,)), 2), (2,))
    dl = dl + (torch.exp(end[:, :, 0]) * (ds_out * s).sum((-1, -2)))[:, :, None]
    u = w * g_upd
    dl = dl + torch.cumsum(u, 2) - u
    return dx, ddt + dl * A, (dl * dt).sum((0, 1, 2)), dB, dC, dD


def _straddle(n: int, device) -> torch.Tensor:
    """(n * n, n) f32 mask over a chunk's (t, s) pairs: entry ((t, s), q) is
    1 where exp(cw_t - cw_s) holds step q's log decay, s < q <= t."""
    i = torch.arange(n, device=device)
    m = (i[None, :, None] < i[None, None, :]) & (i[None, None, :] <= i[:, None, None])
    return m.reshape(n * n, n).float()


def ssd_vjp(x, dt, A, B, C, D, state0, chunk_states, dy, ds_final):
    """The VJP of ``ssd_ref`` (y with its D x skip, final_state) from the
    states entering its chunks (``chunk_states``, (b, H, C, P, N), as the
    kernel writes them): the cotangents dy (b, T, H, P) and ds_final (b, H,
    P, N) or None -> (dx, ddt, dA, dB, dC, dD, dstate0), f32.

    The reverse scan over the C chunks is the only sequential part, one
    fused multiply-add on the (b, H, P, N) state a chunk:

        dS_c = exp(cw_end,c) dS_{c+1} + sum_t exp(cw_t) dy_t C_t^T

    (cw inclusive: y_t reads the state after step t). Every chunk then
    takes its local VJP at once (``_chunk_vjp``), with the state entering
    it a constant, in groups under ``build.chunk_groups``' budget.
    """
    del state0  # it enters through chunk_states[:, :, 0]
    b, t, h, p = x.shape
    n = B.shape[-1]
    x, dt, A, B, C, D, dy = (a.float() for a in (x, dt, A, B, C, D, dy))
    xc, dtc, bc, cc, dyc = (build.to_chunks(a, CHUNK) for a in (x, dt, B, C, dy))
    c = xc.shape[1]
    s_in = chunk_states.float().transpose(1, 2)  # (b, C, H, P, N)
    cw = torch.cumsum(dtc * A, dim=2)
    q = torch.einsum("bcthp,bctn->bchpn", dyc * torch.exp(cw)[..., None], cc)
    decay = torch.exp(cw[:, :, -1])[..., None, None]  # (b, C, H, 1, 1)
    ds_out = torch.empty_like(s_in)
    cur = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device) if ds_final is None \
        else ds_final.float()
    for i in reversed(range(c)):
        ds_out[:, i] = cur
        cur = decay[:, i] * cur + q[:, i]
    grads = [torch.empty_like(a) for a in (xc, dtc, bc, cc)]
    dA, dD = torch.zeros_like(A), torch.zeros_like(D)
    for g in build.chunk_groups(c, b * h * max(p * n, CHUNK * CHUNK)):
        gx, gdt, gA, gB, gC, gD = _chunk_vjp(xc[:, g], dtc[:, g], A, bc[:, g], cc[:, g], D, s_in[:, g],
                                             dyc[:, g], ds_out[:, g])
        for total, pt in zip(grads, (gx, gdt, gB, gC)):
            total[:, g] = pt
        dA += gA
        dD += gD
    dx, ddt, dB, dC = (a.reshape(b, c * CHUNK, *a.shape[3:])[:, :t] for a in grads)
    return dx, ddt, dA, dB, dC, dD, cur
