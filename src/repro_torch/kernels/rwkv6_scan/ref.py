"""Plain PyTorch WKV6: the sequential recurrence of
``repro/kernels/rwkv6_scan/ref.py`` and ``repro/models/rwkv6.py`` ``_wkv6_seq``."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build


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


CHUNK = 32  # tokens per chunk in the kernel (kC in csrc/wkv6.cu)
# Clusters of n prefill blocks an H100 keeps resident at once
# (cudaOccupancyMaxActiveClusters: two blocks on each of 132 SMs, less
# what a cluster's placement within one GPC loses at 4 and 8). The card
# tests hold the card to these counts.
RESIDENT_CLUSTERS = {1: 264, 2: 132, 4: 62, 8: 30}


def split_count(t: int, b: int, h: int) -> int:
    """How many blocks of a cluster the kernel splits each (b, h) sequence of
    ``t`` tokens over (``build.split_count``): doubled up to 8 while every
    block keeps at least one whole chunk and the b * h clusters of the
    doubled count are all resident at once, since a cluster left for a
    second wave runs after a whole block's time. A decode step (t = 1)
    gets 1; rwkv6-7b's prompt (T = 512, 64 heads) gets 2."""
    return build.split_count(-(-t // CHUNK), 1, lambda n: b * h <= RESIDENT_CLUSTERS[2 * n])


def split_chunks(t: int, n_split: int, j: int):
    """The chunks block ``j`` of ``n_split`` takes of the C = ceil(t / CHUNK)
    chunks (``build.chunk_span``)."""
    return build.chunk_span(-(-t // CHUNK), n_split, j)


def wkv6_split_ref(r, k, v, lw, u, state: Optional[torch.Tensor] = None, n_split: int = 1):
    """The prefill kernel's algorithm in plain PyTorch, same arguments and
    result as ``wkv6_ref``, with each sequence split over ``n_split`` blocks.

    Block j takes the chunks ``split_chunks`` gives it. From a zero state it
    forms, chunk by chunk in the closed form (cw the inclusive and ce the
    exclusive cumulative sum of lw within the chunk, every exponent <= 0),
    its local outputs y_loc = A v + (r o exp(ce)) L, with A[t,s] = sum_k
    r[t,k] k[s,k] exp(ce[t,k] - cw[s,k]) below the diagonal and r u k on
    it, and its local state L <- diag(exp(cw_end)) L + (k o exp(cw_end -
    cw))^T v; its total decay is delta_j = exp(cwb_end), cwb the cumulative
    sum of lw over all its tokens. The state entering block j folds in
    block order, S = S0 then S = diag(delta_i) S + L_i for i < j; block j's
    outputs are y_loc + (r o exp(cwb_excl)) S, cwb_excl the block's
    exclusive running sum (0 at its first token: y reads the state before
    its token). The final state is the fold past the last block. The card
    tests hold the kernel to it as a second oracle; nothing on the main path
    calls it.
    """
    b, t, h, hd = r.shape
    r, k, v, lw, u = (a.float() for a in (r, k, v, lw, u))
    dev = r.device
    s_in = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=dev) if state is None \
        else state.float()
    y = torch.empty((b, t, h, hd), dtype=torch.float32, device=dev)
    carried = []  # (exclusive cwb per token, t0, t1, S entering) of each block
    for j in range(n_split):
        c0, c1 = split_chunks(t, n_split, j)
        t0, t1 = min(c0 * CHUNK, t), min(c1 * CHUNK, t)
        loc = torch.zeros_like(s_in)
        run = torch.zeros((b, h, hd), dtype=torch.float32, device=dev)
        cwb = []
        for s0 in range(t0, t1, CHUNK):
            s1 = min(s0 + CHUNK, t1)
            n = s1 - s0
            rc, kc, vc, wc = r[:, s0:s1], k[:, s0:s1], v[:, s0:s1], lw[:, s0:s1]
            cw = torch.cumsum(wc, dim=1)  # (b, n, h, hd)
            ce = torch.cat([torch.zeros_like(cw[:, :1]), cw[:, :-1]], dim=1)
            below = torch.tril(torch.ones(n, n, dtype=torch.bool, device=dev), -1)
            expo = torch.where(below[None, :, :, None, None], ce[:, :, None] - cw[:, None], -torch.inf)
            a = torch.einsum("bthk,bshk,btshk->btsh", rc, kc, torch.exp(expo))
            diag = torch.einsum("bthk,hk,bthk->bth", rc, u, kc)
            a = a + torch.diag_embed(diag.transpose(1, 2)).permute(0, 2, 3, 1)
            yc = torch.einsum("btsh,bshv->bthv", a, vc)
            y[:, s0:s1] = yc + torch.einsum("bthk,bhkv->bthv", rc * torch.exp(ce), loc)
            end = cw[:, -1]  # (b, h, hd)
            kt = kc * torch.exp(end[:, None] - cw)
            loc = torch.exp(end)[..., None] * loc + torch.einsum("bshk,bshv->bhkv", kt, vc)
            cwb.append(run[:, None] + ce)
            run = run + end
        carried.append((torch.cat(cwb, 1) if cwb else None, t0, t1, s_in))
        s_in = torch.exp(run)[..., None] * s_in + loc
    for cwb, t0, t1, s_blk in carried:
        if cwb is not None:
            y[:, t0:t1] += torch.einsum("bthk,bhkv->bthv", r[:, t0:t1] * torch.exp(cwb), s_blk)
    return y, s_in
