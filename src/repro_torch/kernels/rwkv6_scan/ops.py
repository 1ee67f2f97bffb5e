"""Public WKV6 op (RWKV6's time-mix recurrence), routed by device.

``wkv6_chunked(r, k, v, lw, u, state=None)`` takes the model layout of
``repro/kernels/rwkv6_scan/ops.py``: r, k, v and the log-decay lw (<= 0)
(B, T, H, hd), the bonus u (H, hd) and a state (B, H, hd, hd) or None for
zeros; it returns (y (B, T, H, hd) f32, final_state (B, H, hd, hd) f32).
With ``inplace=True`` the final state is written into ``state`` itself
and ``state`` is returned: the model's decode updates its cache that way.
With ``return_states=True`` it also returns the state entering each chunk
of ``ref.CHUNK`` tokens, (B, H, C, hd, hd) f32, C = ceil(T / CHUNK): the
kernel writes them through an optional pointer (null in serving), and
``WKV6Fn``'s backward reads them.

The op takes what the kernel is built for, on every device: f32 inputs,
T >= 1 and hd 16, 32 or 64; anything else raises. CPU tensors take the
plain version in ``ref.py``. CUDA tensors launch the hand-written kernel
of ``csrc/wkv6.cu`` (built at first use), which reads r, k, v and lw
through their strides (unit stride along hd) and masks its ragged last
chunk, so unlike the TPU op nothing is transposed to (B, H, T, hd) and T
is not padded to a chunk multiple. A prompt is split over the blocks of a
cluster, as many as ``ref.split_count`` gives from the shapes; a decode
step (T = 1) streams the state through registers. ``LAUNCHES`` counts
kernel launches, and only kernel launches. Meta tensors inside a cost
walk take the shape-only route (``build.shape_only``).
``ref.wkv6_split_ref`` is the prefill kernel's algorithm in plain
PyTorch, for tests.

``WKV6Fn`` (``wkv6_train``) is the op a training forward takes: its
forward is ``wkv6_chunked(..., return_states=True)`` with grad mode off
(so the kernel on the card, the plain version on the CPU), its backward
the chunked VJP in plain PyTorch, ``ref.wkv6_vjp``, which reads the saved
chunk-entry states. The TPU kernel has no backward, and the reference
differentiates its jnp scan; a hand-written backward kernel is a later
redesign.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, work
from repro_torch.kernels.build import need
from repro_torch.kernels.rwkv6_scan import ref

LAUNCHES = {"wkv6": 0}
HEAD_DIMS = (16, 32, 64)

_P, _I, _S = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)


def _lib() -> ctypes.CDLL:
    lib = build.load("wkv6")
    if not getattr(lib, "_declared", False):
        lib.wkv6_forward.argtypes = [_P, _S, _P, _S, _P, _S, _P, _S, _P, _P, _P, _P, _P,
                                     _I, _I, _I, _I, _I, _P]
        lib.wkv6_forward.restype = _I
        lib.wkv6_max_active_clusters.argtypes = [_I, _I, ctypes.POINTER(_I)]
        lib.wkv6_max_active_clusters.restype = _I
        lib._declared = True
    return lib


def wkv6_chunked(r, k, v, lw, u, state: Optional[torch.Tensor] = None, *, inplace: bool = False,
                 return_states: bool = False):
    """r/k/v/lw: (B, T, H, hd) f32; u: (H, hd) f32; state: (B, H, hd, hd) f32
    or None -> (y (B, T, H, hd) f32, final_state (B, H, hd, hd) f32), and
    with ``return_states`` the chunk-entry states (B, H, C, hd, hd) f32."""
    need(r.ndim == 4 and k.shape == r.shape and v.shape == r.shape and lw.shape == r.shape,
         f"r, k, v, lw must be four (B, T, H, hd) tensors, got {tuple(r.shape)} {tuple(k.shape)} "
         f"{tuple(v.shape)} {tuple(lw.shape)}")
    b, t, h, hd = r.shape
    need(u.shape == (h, hd), f"u must be ({h}, {hd}), got {tuple(u.shape)}")
    need(state is None or state.shape == (b, h, hd, hd),
         f"state must be ({b}, {h}, {hd}, {hd}), got {None if state is None else tuple(state.shape)}")
    need(all(x.dtype == torch.float32 for x in (r, k, v, lw, u, state) if x is not None),
         "r, k, v, lw, u and state must be float32")
    need(hd in HEAD_DIMS, f"head_dim {hd} is not built: the kernel takes {HEAD_DIMS}")
    need(t >= 1, "the sequence is empty")
    need(not inplace or state is not None, "inplace needs a state to write into")
    if build.shape_only(r, k, v, lw, u, state):
        build.record("wkv6", work.wkv6(b, t, h, hd, state is not None, return_states))
        new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=r.device)
        states = (new(b, h, -(-t // ref.CHUNK), hd, hd),) if return_states else ()
        return (new(b, t, h, hd), state if inplace else new(b, h, hd, hd), *states)
    if not build.on_cuda("wkv6", r, k, v, lw, u, state):
        y, s, *states = ref.wkv6_ref(r, k, v, lw, u, state, return_states=return_states)
        if inplace:
            state.copy_(s)
            s = state
        return (y, s, *states)
    for name, x in (("r", r), ("k", k), ("v", v), ("lw", lw)):
        need(x.stride(-1) == 1, f"{name} needs unit stride along head_dim")
    need(u.is_contiguous() and (state is None or state.is_contiguous()),
         "u and state must be contiguous")
    need(state is None or state.data_ptr() % 16 == 0, "state must start on a 16-byte boundary")
    return _launch(r, k, v, lw, u, state, state if inplace else None, ref.split_count(t, b, h),
                   return_states)


def _launch(r, k, v, lw, u, state, s_out, n_split: int, return_states: bool = False):
    """The kernel on checked CUDA inputs, each sequence split over
    ``n_split`` blocks of a cluster, the final state into ``s_out`` (a new
    tensor when None), and with ``return_states`` the chunk-entry states
    into a new (B, H, C, hd, hd) tensor, returned third; the kernel raises
    for n_split outside 1..8."""
    b, t, h, hd = r.shape
    y = torch.empty((b, t, h, hd), dtype=torch.float32, device=r.device)
    if s_out is None:
        s_out = torch.empty((b, h, hd, hd), dtype=torch.float32, device=r.device)
    states = (torch.empty((b, h, -(-t // ref.CHUNK), hd, hd), dtype=torch.float32, device=r.device),) \
        if return_states else ()
    if b * h == 0:
        return (y, s_out, *states)
    lib = _lib()
    with torch.cuda.device(r.device):
        err = lib.wkv6_forward(
            r.data_ptr(), build.strides(r, 3), k.data_ptr(), build.strides(k, 3),
            v.data_ptr(), build.strides(v, 3), lw.data_ptr(), build.strides(lw, 3),
            u.data_ptr(), None if state is None else state.data_ptr(), y.data_ptr(),
            s_out.data_ptr(), states[0].data_ptr() if states else None, b, t, h, hd, n_split,
            torch.cuda.current_stream(r.device).cuda_stream,
        )
    build.check(lib, err, "wkv6")
    LAUNCHES["wkv6"] += 1
    return (y, s_out, *states)


def max_active_clusters(hd: int, n_split: int) -> int:
    """How many clusters of ``n_split`` prefill blocks at head_dim ``hd`` the
    current card keeps resident at once (``cudaOccupancyMaxActiveClusters``)."""
    lib = _lib()
    out = _I(0)
    build.check(lib, lib.wkv6_max_active_clusters(hd, n_split, ctypes.byref(out)), "wkv6")
    return out.value


class WKV6Fn(torch.autograd.Function):
    """WKV6 with a gradient: the forward runs ``wkv6_chunked`` with its
    chunk-entry states (the kernel on the card, with grad mode off so its
    wrapper takes it; the plain version on the CPU) and saves (r, k, v, lw,
    u, state, chunk states); the backward is ``ref.wkv6_vjp``. A final
    state that the caller never reads gets a zero cotangent."""

    @staticmethod
    def forward(ctx, r, k, v, lw, u, state):
        y, s, states = wkv6_chunked(r, k, v, lw, u, state, return_states=True)
        ctx.save_for_backward(r, k, v, lw, u, state, states)
        return y, s

    @staticmethod
    def backward(ctx, dy, ds):
        r, k, v, lw, u, state, states = ctx.saved_tensors
        dr, dk, dv, dlw, du, ds0 = ref.wkv6_vjp(r, k, v, lw, u, state, states, dy, ds)
        return dr, dk, dv, dlw, du, ds0 if ctx.needs_input_grad[5] else None


def wkv6_train(r, k, v, lw, u, state: Optional[torch.Tensor] = None):
    """``wkv6_chunked``'s (y, final_state) through ``WKV6Fn``: the scan of a
    training forward. A given state is an input, never written."""
    return WKV6Fn.apply(r, k, v, lw, u, state)
