"""Plain PyTorch WKV6: the sequential recurrence of
``repro/kernels/rwkv6_scan/ref.py`` and ``repro/models/rwkv6.py`` ``_wkv6_seq``."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build


def wkv6_ref(r, k, v, lw, u, state: Optional[torch.Tensor] = None, *, return_states: bool = False):
    """r/k/v: (B, T, H, hd); lw: log-decay (B, T, H, hd), <= 0; u: (H, hd);
    state: (B, H, hd, hd) or None (zeros).

    Returns (y (B, T, H, hd) f32, final_state (B, H, hd, hd) f32), with

        S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T
        y_t = r_t (S_{t-1} + diag(u) k_t v_t^T)

    State axes: [k-dim, v-dim]. With ``return_states`` also the state
    entering each chunk of ``CHUNK`` tokens, (B, H, C, hd, hd) f32 with C =
    ceil(T / CHUNK): the kernel's chunk-entry states, which ``wkv6_vjp``
    reads.
    """
    b, t, h, hd = r.shape
    r, k, v, u = r.float(), k.float(), v.float(), u.float()
    w = torch.exp(lw.float())
    s = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device) if state is None \
        else state.float()
    ys, states = [], []
    for i in range(t):
        if i % CHUNK == 0:
            states.append(s)
        kv = k[:, i, :, :, None] * v[:, i, :, None, :]  # (B, H, hd, hd)
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, i], s + u[None, :, :, None] * kv))
        s = w[:, i, :, :, None] * s + kv
    if return_states:
        return torch.stack(ys, dim=1), s, torch.stack(states, dim=2)
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



def _straddle(n: int, device) -> torch.Tensor:
    """(n * n, n) f32 mask over a chunk's (t, s) pairs: entry ((t, s), q) is
    1 where exp(ce_t - cw_s) holds step q's log decay, s < q < t."""
    i = torch.arange(n, device=device)
    m = (i[None, :, None] < i[None, None, :]) & (i[None, None, :] < i[:, None, None])
    return m.reshape(n * n, n).float()


def _chunk_vjp(r, k, v, lw, u, s, dy, ds_out):
    """The VJP of one chunk of the closed form, by hand, batched over a
    group of G chunks: r, k, v, lw, dy (B, G, n, H, hd); u (H, hd); s and
    ds_out (B, G, H, hd, hd), the state entering each chunk and the
    cotangent of the state leaving it -> (dr, dk, dv, dlw, du).

    Forward, per chunk (cw, ce the inclusive and exclusive cumulative sums
    of lw; every exponent <= 0):

        A[t,s] = sum_k r_tk k_sk exp(ce_tk - cw_sk)  (s < t),  g_t = sum_k r_tk u_k k_tk
        y_t    = sum_s A[t,s] v_s + g_t v_t + (r_t o exp(ce_t)) S
        S'     = diag(exp(cw_end)) S + sum_s (k_s o exp(cw_end - cw_s)) v_s^T

    The gradient of each step's log decay lw_q is summed directly over the
    terms whose exponent holds it (pairs with s < q < t, outputs after q,
    the state's decay, state updates before q) and never as a difference of
    cumulative sums, which would cancel to some 1e-4 of the scale when the
    chunk's decays are strong."""
    n = r.shape[2]
    cw = torch.cumsum(lw, dim=2)
    ce = torch.cat([torch.zeros_like(cw[:, :, :1]), cw[:, :, :-1]], dim=2)
    below = torch.tril(torch.ones(n, n, dtype=torch.bool, device=r.device), -1)
    e = torch.exp(torch.where(below[:, :, None, None], ce[:, :, :, None] - cw[:, :, None], -torch.inf))
    end = cw[:, :, -1:]  # (B, G, 1, H, hd)
    rc, kt = r * torch.exp(ce), k * torch.exp(end - cw)
    da = torch.einsum("bgthv,bgshv->bgtsh", dy, v) * below[:, :, None]  # dA (B, G, t, s, H)
    a = torch.einsum("bgthk,bgshk,bgtshk->bgtsh", r, k, e)
    g = (r * u * k).sum(-1, keepdim=True)
    dg = (dy * v).sum(-1, keepdim=True)
    drc = torch.einsum("bgthv,bghkv->bgthk", dy, s)
    dkt = torch.einsum("bghkv,bgshv->bgshk", ds_out, v)
    dv = torch.einsum("bgtsh,bgthv->bgshv", a, dy) + g * dy + torch.einsum("bgshk,bghkv->bgshv", kt, ds_out)
    we = da[..., None] * e  # (B, G, t, s, H, hd)
    dr = torch.einsum("bgtshk,bgshk->bgthk", we, k) + dg * u * k + drc * torch.exp(ce)
    dk = torch.einsum("bgtshk,bgthk->bgshk", we, r) + dg * u * r + dkt * torch.exp(end - cw)
    du = (dg * r * k).sum((0, 1, 2))
    # d lw_q: pairs (t, s) with s < q < t; outputs t > q through exp(ce_t);
    # the state's decay; state updates s < q through exp(cw_end - cw_s)
    w = (we * r[:, :, :, None] * k[:, :, None]).permute(0, 1, 4, 5, 2, 3)  # (B, G, H, hd, t, s)
    dlw = (w.reshape(*w.shape[:4], n * n) @ _straddle(n, r.device)).permute(0, 1, 4, 2, 3)
    dlw = dlw + torch.flip(torch.cumsum(torch.flip(drc * rc, (2,)), 2), (2,)) - drc * rc
    dlw = dlw + (torch.exp(end[:, :, 0]) * (ds_out * s).sum(-1))[:, :, None]
    dlw = dlw + torch.cumsum(dkt * kt, 2) - dkt * kt
    return dr, dk, dv, dlw, du


def wkv6_vjp(r, k, v, lw, u, state0, chunk_states, dy, ds_final):
    """The VJP of ``wkv6_ref`` (y, final_state) from the states entering its
    chunks (``chunk_states``, (B, H, C, hd, hd), as the kernel writes them):
    the cotangents dy (B, T, H, hd) and ds_final (B, H, hd, hd) or None ->
    (dr, dk, dv, dlw, du, dstate0), f32, dstate0 (B, H, hd, hd) whether
    ``state0`` is given or not.

    The only sequential part is the reverse scan over the C chunks, one
    fused multiply-add on the (B, H, hd, hd) state a chunk:

        dS_c = diag(exp(cw_end,c)) dS_{c+1} + sum_t (r_t o exp(ce_t)) dy_t^T

    (dS_C = ds_final, dS_0 = dstate0). Every chunk then takes its local
    VJP at once (``_chunk_vjp``), with the state entering it a constant and
    dS_{c+1} the cotangent of the state leaving it, in groups of chunks
    whose largest tensor, (B, G, n, n, H, hd), stays under
    ``build.chunk_groups``' budget.
    """
    del state0  # it enters through chunk_states[:, :, 0]
    b, t, h, hd = r.shape
    r, k, v, lw, u, dy = (x.float() for x in (r, k, v, lw, u, dy))
    rc, kc, vc, wc, dyc = (build.to_chunks(x, CHUNK) for x in (r, k, v, lw, dy))
    c = rc.shape[1]
    s_in = chunk_states.float().transpose(1, 2)  # (B, C, H, hd, hd)
    cw = torch.cumsum(wc, dim=2)
    ce = torch.cat([torch.zeros_like(cw[:, :, :1]), cw[:, :, :-1]], dim=2)
    q = torch.einsum("bcthk,bcthv->bchkv", rc * torch.exp(ce), dyc)
    decay = torch.exp(cw[:, :, -1])[..., None]  # (B, C, H, hd, 1)
    ds_out = torch.empty_like(s_in)  # the cotangent of the state leaving each chunk
    cur = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device) if ds_final is None \
        else ds_final.float()
    for i in reversed(range(c)):
        ds_out[:, i] = cur
        cur = decay[:, i] * cur + q[:, i]
    grads = [torch.empty_like(x) for x in (rc, kc, vc, wc)] + [torch.zeros_like(u)]
    for g in build.chunk_groups(c, b * CHUNK * CHUNK * h * hd):
        part = _chunk_vjp(rc[:, g], kc[:, g], vc[:, g], wc[:, g], u, s_in[:, g], dyc[:, g], ds_out[:, g])
        for total, p in zip(grads[:4], part[:4]):
            total[:, g] = p
        grads[4] += part[4]
    dr, dk, dv, dlw = (x.reshape(b, c * CHUNK, h, hd)[:, :t] for x in grads[:4])
    return dr, dk, dv, dlw, grads[4], cur
