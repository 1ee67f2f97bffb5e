"""Public SSD op (the Mamba2 scan), routed by device.

``ssd_chunked(x, dt, A, B, C, D, state=None)`` takes the model layout of
``repro/kernels/mamba2_scan/ops.py``: x (b, T, H, P), dt (b, T, H), A and
D (H,), B and C (b, T, N) shared by the heads, and a state (b, H, P, N)
or None for zeros; it returns (y (b, T, H, P) f32, final_state (b, H, P,
N) f32). With ``inplace=True`` the final state is written into ``state``
itself and ``state`` is returned: the model's decode updates its cache
that way. With ``return_states=True`` it also returns the state entering
each chunk of ``ref.CHUNK`` steps, (b, H, C, P, N) f32, C = ceil(T /
CHUNK): the kernel writes them through an optional pointer (null in
serving), and ``SSDFn``'s backward reads them.

The op takes what the kernel is built for, on every device: f32 inputs,
T >= 1, and P and N each 16, 32 or 64; anything else raises. CPU tensors
take the plain version in ``ref.py``. CUDA tensors launch the
hand-written kernel of ``csrc/ssd.cu`` (built at first use), which reads
x, dt, B and C through their strides (unit stride along P and N) and
masks its ragged last chunk, so unlike the TPU op nothing is transposed
and T is not padded. A prompt is split over the blocks of a cluster, as
many as ``ref.split_count`` gives from the shapes; a decode step (T = 1)
streams the state through registers. ``LAUNCHES`` counts kernel
launches, and only kernel launches. Meta tensors inside a cost walk take
the shape-only route (``build.shape_only``). ``ref.ssd_split_ref`` is the
prefill kernel's algorithm in plain PyTorch, for tests.

``SSDFn`` (``ssd_train``) is the op a training forward takes: its forward
is ``ssd_chunked(..., return_states=True)`` with grad mode off (the kernel
on the card, the plain version on the CPU), its backward the chunked VJP
in plain PyTorch, ``ref.ssd_vjp``, which reads the saved chunk-entry
states. The TPU kernel has no backward; a hand-written one is a later
redesign.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, work
from repro_torch.kernels.build import need
from repro_torch.kernels.mamba2_scan import ref

LAUNCHES = {"ssd": 0}
SIZES = (16, 32, 64)

_P, _I, _S = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)


def _lib() -> ctypes.CDLL:
    lib = build.load("ssd")
    if not getattr(lib, "_declared", False):
        lib.ssd_forward.argtypes = [_P, _S, _P, _S, _P, _S, _P, _S, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _P]
        lib.ssd_forward.restype = _I
        lib.ssd_max_active_clusters.argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
        lib.ssd_max_active_clusters.restype = _I
        lib._declared = True
    return lib


def ssd_chunked(x, dt, A, B, C, D, state: Optional[torch.Tensor] = None, *, inplace: bool = False,
                return_states: bool = False):
    """x: (b, T, H, P); dt: (b, T, H); A, D: (H,); B, C: (b, T, N); state:
    (b, H, P, N) or None; all f32 -> (y (b, T, H, P), final_state (b, H, P,
    N)), and with ``return_states`` the chunk-entry states (b, H, C, P, N)."""
    need(x.ndim == 4, f"x must be (b, T, H, P), got {tuple(x.shape)}")
    b, t, h, p = x.shape
    need(dt.shape == (b, t, h), f"dt must be ({b}, {t}, {h}), got {tuple(dt.shape)}")
    need(A.shape == (h,) and D.shape == (h,), f"A and D must be ({h},), got {tuple(A.shape)} {tuple(D.shape)}")
    need(B.ndim == 3 and B.shape[:2] == (b, t) and C.shape == B.shape,
         f"B and C must be two ({b}, {t}, N) tensors, got {tuple(B.shape)} {tuple(C.shape)}")
    n = B.shape[2]
    need(state is None or state.shape == (b, h, p, n),
         f"state must be ({b}, {h}, {p}, {n}), got {None if state is None else tuple(state.shape)}")
    need(all(a.dtype == torch.float32 for a in (x, dt, A, B, C, D, state) if a is not None),
         "x, dt, A, B, C, D and state must be float32")
    need(p in SIZES and n in SIZES, f"P = {p}, N = {n} is not built: the kernel takes {SIZES} each")
    need(t >= 1, "the sequence is empty")
    need(not inplace or state is not None, "inplace needs a state to write into")
    if build.shape_only(x, dt, A, B, C, D, state):
        build.record("ssd", work.ssd(b, t, h, p, n, state is not None, return_states))
        new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=x.device)
        states = (new(b, h, -(-t // ref.CHUNK), p, n),) if return_states else ()
        return (new(b, t, h, p), state if inplace else new(b, h, p, n), *states)
    if not build.on_cuda("ssd", x, dt, A, B, C, D, state):
        y, s, *states = ref.ssd_ref(x, dt, A, B, C, D, state, return_states=return_states)
        if inplace:
            state.copy_(s)
            s = state
        return (y, s, *states)
    for name, a in (("x", x), ("B", B), ("C", C)):
        need(a.stride(-1) == 1, f"{name} needs unit stride along its last dim")
    need(A.is_contiguous() and D.is_contiguous() and (state is None or state.is_contiguous()),
         "A, D and state must be contiguous")
    need(state is None or state.data_ptr() % 16 == 0, "state must start on a 16-byte boundary")
    return _launch(x, dt, A, B, C, D, state, state if inplace else None, ref.split_count(t, b, h),
                   return_states)


def _launch(x, dt, A, B, C, D, state, s_out, n_split: int, return_states: bool = False):
    """The kernel on checked CUDA inputs, each sequence split over
    ``n_split`` blocks of a cluster, the final state into ``s_out`` (a new
    tensor when None), and with ``return_states`` the chunk-entry states
    into a new (b, H, C, P, N) tensor, returned third; the kernel raises
    for n_split outside 1..8."""
    b, t, h, p = x.shape
    n = B.shape[2]
    y = torch.empty((b, t, h, p), dtype=torch.float32, device=x.device)
    if s_out is None:
        s_out = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    states = (torch.empty((b, h, -(-t // ref.CHUNK), p, n), dtype=torch.float32, device=x.device),) \
        if return_states else ()
    if b * h == 0:
        return (y, s_out, *states)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.ssd_forward(
            x.data_ptr(), build.strides(x, 3), dt.data_ptr(), build.strides(dt, 3),
            B.data_ptr(), build.strides(B, 2), C.data_ptr(), build.strides(C, 2), A.data_ptr(),
            D.data_ptr(), None if state is None else state.data_ptr(), y.data_ptr(),
            s_out.data_ptr(), states[0].data_ptr() if states else None, b, t, h, p, n, n_split,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    build.check(lib, err, "ssd")
    LAUNCHES["ssd"] += 1
    return (y, s_out, *states)


def max_active_clusters(p: int, n: int, n_split: int) -> int:
    """How many clusters of ``n_split`` prefill blocks at P = p, N = n the
    current card keeps resident at once (``cudaOccupancyMaxActiveClusters``)."""
    lib = _lib()
    out = _I(0)
    build.check(lib, lib.ssd_max_active_clusters(p, n, n_split, ctypes.byref(out)), "ssd")
    return out.value


class SSDFn(torch.autograd.Function):
    """The SSD scan with a gradient: the forward runs ``ssd_chunked`` with
    its chunk-entry states (the kernel on the card, with grad mode off so
    its wrapper takes it; the plain version on the CPU) and saves the inputs
    and the chunk states; the backward is ``ref.ssd_vjp``, the ``D x`` skip
    included. A final state that the caller never reads gets a zero
    cotangent."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, state):
        y, s, states = ssd_chunked(x, dt, A, B, C, D, state, return_states=True)
        ctx.save_for_backward(x, dt, A, B, C, D, state, states)
        return y, s

    @staticmethod
    def backward(ctx, dy, ds):
        x, dt, A, B, C, D, state, states = ctx.saved_tensors
        *grads, ds0 = ref.ssd_vjp(x, dt, A, B, C, D, state, states, dy, ds)
        return (*grads, ds0 if ctx.needs_input_grad[6] else None)


def ssd_train(x, dt, A, B, C, D, state: Optional[torch.Tensor] = None):
    """``ssd_chunked``'s (y, final_state) through ``SSDFn``: the scan of a
    training forward. A given state is an input, never written."""
    return SSDFn.apply(x, dt, A, B, C, D, state)
