"""Public flash-attention op (prefill attention), routed by device.

``flash_attention(q, k, v, *, causal, lk_valid, q_offset)`` takes the
shapes of ``repro/kernels/flash_attention/ops.py``: q (B, Hq, Lq, D) and k,
v (B, Hkv, Lk, D) with Hq % Hkv == 0, and returns (B, Hq, Lq, D) in q's
dtype. ``lk_valid`` and ``q_offset`` have the TPU kernel's meaning (see
``ref.py``).

The op takes what the kernel is built for, on every device: q, k and v of
one dtype, f32 or bf16, and head_dim 64 or 128; anything else raises.
CPU tensors take the plain version in ``ref.py``. CUDA tensors launch the
hand-written kernel of ``csrc/flash_attention.cu`` (built at first use):
its products run on the tensor cores over tiles that TMA loads, in bf16
or, for f32, as three TF32 products of split operands each. It reads q,
k and v through their strides, so the model's transposed projection views
go in without a copy;
they need unit stride along head_dim and 16-byte aligned rows, and raise
otherwise. Unlike the TPU op nothing is padded: ragged tiles are
zero-filled and masked. With ``return_lse`` the kernel also writes each
row's softmax stats (lse, f32), which the training forward's attention
Function (``models.common.AttentionFn``) saves for its backward; a call
without it stores nothing more. ``LAUNCHES`` counts kernel launches, and
only kernel launches. Meta tensors inside a cost walk take the shape-only
route (``build.shape_only``): empty outputs, the work recorded, no
launch. Under grad mode an input that requires grad raises
(``build.on_cuda``): the kernel records no autograd history. ``ref.flash_attention_tiled_ref`` and
``ref.flash_attention_tf32_ref`` are the bf16 and f32 kernels' algorithms
(tiles of 64 keys; p in three bf16 parts, or three TF32 products) in
plain PyTorch, for tests.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build, work
from repro_torch.kernels.build import need
from repro_torch.kernels.flash_attention import ref

LAUNCHES = {"flash_attention": 0}
HEAD_DIMS = (64, 128)

_KIND = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _S = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    if not getattr(lib, "_declared", False):
        lib.fa_forward.argtypes = [_P, _S, _P, _S, _P, _S, _P, _I, _I, _I, _I, _I, _I, _I,
                                   _I, _I, _I, ctypes.c_float, _P, _P]
        lib.fa_forward.restype = _I
        lib._declared = True
    return lib


def flash_attention(q, k, v, *, causal: bool = True, lk_valid: Optional[int] = None,
                    q_offset: Optional[int] = None, return_lse: bool = False):
    """q: (B, Hq, Lq, D); k/v: (B, Hkv, Lk, D) -> (B, Hq, Lq, D) in q.dtype.

    With ``return_lse`` it returns ``(out, lse)``, lse f32 (B, Hq, Lq): each
    row's log-sum-exp of its scaled, masked scores, the softmax stats a
    backward recomputes p from (the kernel writes 0 for a row that no key
    reached; see ``ref.flash_attention_ref``).
    """
    need(q.ndim == 4 and k.ndim == 4 and v.ndim == 4,
         f"q, k, v must be (B, H, L, D), got {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    need(v.shape == k.shape and k.shape[0] == b and k.shape[3] == d,
         f"k and v must be ({b}, Hkv, Lk, {d}), got {tuple(k.shape)} {tuple(v.shape)}")
    need(hkv > 0 and hq % hkv == 0, f"{hq} query heads do not group over {hkv} KV heads")
    need(q.dtype in _KIND and k.dtype == q.dtype and v.dtype == q.dtype,
         f"q, k, v must share one dtype of {sorted(map(str, _KIND))}, got {q.dtype} {k.dtype} {v.dtype}")
    need(d in HEAD_DIMS, f"head_dim {d} is not built: the kernel takes {HEAD_DIMS}")
    lk_valid = lk if lk_valid is None else int(lk_valid)
    q_offset = lk_valid - lq if q_offset is None else int(q_offset)
    if build.shape_only(q, k, v):
        build.record("flash_attention", work.flash_attention(
            b, hq, hkv, lq, lk, d, q.element_size(), causal, q_offset, lk_valid, return_lse))
        out = torch.empty((b, hq, lq, d), dtype=q.dtype, device=q.device)
        lse = torch.empty((b, hq, lq), dtype=torch.float32, device=q.device) if return_lse else None
        return (out, lse) if return_lse else out
    if not build.on_cuda("flash_attention", q, k, v):
        return ref.flash_attention_ref(q, k, v, causal=causal, lk_valid=lk_valid, q_offset=q_offset,
                                       return_lse=return_lse)
    for name, t in (("q", q), ("k", k), ("v", v)):
        need(build.vector_aligned(t), f"{name} needs unit stride along head_dim and 16-byte aligned rows")
    out = torch.empty((b, hq, lq, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, lq), dtype=torch.float32, device=q.device) if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.fa_forward(
            q.data_ptr(), build.strides(q, 3), k.data_ptr(), build.strides(k, 3),
            v.data_ptr(), build.strides(v, 3), out.data_ptr(), _KIND[q.dtype], d, b, hq, hkv,
            lq, lk, int(causal), lk_valid, q_offset, 1.0 / math.sqrt(d),
            None if lse is None else lse.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    build.check(lib, err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return (out, lse) if return_lse else out
