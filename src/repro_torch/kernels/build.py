"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/lib<name>-<key>.so`` beside this package, where ``key`` hashes
the source, the flags and the compiler's path, so an edited source builds
anew and an unchanged one is loaded as it is. Building happens at first
use (never at import), one nvcc process per source, all started together.
Nothing here falls back: a missing nvcc or a failed compile raises.

The routing helpers at the end are shared by every wrapper in ``ops.py``:
CPU tensors take the plain version, CUDA tensors the kernel, and meta
tensors inside a cost walk the shape-only route (``shape_only``); so is
the rule by which the cluster kernels split a sequence (``split_count``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
SOURCES = ("tiered_gather", "flash_attention", "paged_attention", "wkv6", "ssd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin)")
    return path


def target(name: str) -> Path:
    """The library path for ``csrc/<name>.cu`` at its current content."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc().encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every source that has no current library, in parallel.

    The compiler's report (``-Xptxas=-v``: registers, spills) is kept in
    ``<library>.log``. Raises with nvcc's output if any compile fails.
    """
    BUILD.mkdir(parents=True, exist_ok=True)
    out = {n: target(n) for n in names}
    procs = {}
    for n, lib in out.items():
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for n, (p, tmp) in procs.items():
        log, _ = p.communicate()
        out[n].with_name(out[n].name + ".log").write_text(log)
        if p.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {p.returncode}):\n{log}")
        else:
            os.replace(tmp, out[n])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    if name not in _LIBS:
        lib = ctypes.CDLL(str(build_all([name])[name]))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def check(lib: ctypes.CDLL, err: int, what: str):
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


# the cost walks in progress (``launch/op_analysis.py``), innermost last:
# inside one, a wrapper given meta tensors returns empty outputs of its
# kernel's shapes and records the kernel's work (``kernels/work.py``) in
# the walk instead of launching; outside one, meta raises as any device
# without a kernel
WALKS: list = []


def shape_only(*tensors) -> bool:
    """True when a cost walk is in progress and every given tensor lies on
    the meta device: the wrapper then takes its shape-only route, which
    builds nothing, launches nothing and moves no ``LAUNCHES`` count."""
    present = [t for t in tensors if t is not None]
    return bool(WALKS) and bool(present) and all(t.is_meta for t in present)


def record(name: str, work):
    """Record one kernel call's ``(bytes, operations, peak)`` in the
    innermost cost walk."""
    WALKS[-1].kernel(name, work)


def kernel_route(t: torch.Tensor) -> bool:
    """True where the models call the kernels' wrappers rather than their
    eager CPU paths: for a tensor on the card, and for a meta tensor inside
    a cost walk, which prices the card's path."""
    return t.is_cuda or (t.is_meta and bool(WALKS))


def on_cuda(what: str, *tensors) -> bool:
    """True when the inputs lie on one CUDA device, False when on the CPU.

    A kernel fills its output through a raw pointer, so autograd records
    nothing for it: on the card, under grad mode, an input that requires
    grad raises here rather than give an output without history. A caller
    that differentiates through a kernel wraps it in a
    ``torch.autograd.Function``, whose forward runs with grad mode off.
    The plain versions on the CPU are differentiable and pass.
    """
    present = [t for t in tensors if t is not None]
    devs = {t.device for t in present}
    if len(devs) != 1:
        raise ValueError(f"{what}: inputs lie on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {dev}")
    if dev.type == "cuda" and torch.is_grad_enabled() and any(t.requires_grad for t in present):
        raise RuntimeError(f"{what}: the CUDA kernel has no backward, and an input requires grad; "
                           "call it under torch.no_grad() or inside an autograd.Function")
    return dev.type == "cuda"


def need(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def vector_aligned(t: torch.Tensor) -> bool:
    """Unit stride along the last dim and every row on a 16-byte boundary,
    as the kernels' 16-byte loads need (dims of size 1 have no stride)."""
    if t.stride(-1) != 1 or t.data_ptr() % 16:
        return False
    return all(n == 1 or s * t.element_size() % 16 == 0
               for n, s in zip(t.shape[:-1], t.stride()[:-1]))


def strides(t: torch.Tensor, dims: int):
    """The element strides of ``t``'s first ``dims`` dims as a C array."""
    return (ctypes.c_longlong * dims)(*t.stride()[:dims])


MAX_SPLIT = 8  # blocks of one thread-block cluster, the portable most


def split_count(units: int, min_units: int, wider: Callable[[int], bool]) -> int:
    """How many blocks of a cluster a kernel splits each sequence over, the
    rule the cluster kernels share: from 1, doubled up to MAX_SPLIT while
    each of the doubled splits keeps at least ``min_units`` of the
    sequence's ``units`` and ``wider(n)``, the kernel's own occupancy rule
    at the current count n, allows it. From shapes alone, so a wrapper
    computes it without reading the card and passes it to the kernel."""
    n = 1
    while n < MAX_SPLIT and units // (2 * n) >= min_units and wider(n):
        n *= 2
    return n


def chunk_span(chunks: int, n_split: int, j: int):
    """The chunks block ``j`` of ``n_split`` takes of a sequence's ``chunks``,
    as the cluster scan kernels split it: [j C / n, (j + 1) C / n), so each
    block takes floor(C / n) or one more, consecutive, and a block takes
    none when n > C."""
    return j * chunks // n_split, (j + 1) * chunks // n_split


def to_chunks(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """(B, T, ...) -> (B, C, chunk, ...), C = ceil(T / chunk), the last chunk
    padded with zeros: a padded step of a scan (zero inputs, zero log
    decay) leaves its state as it was, and its output is cut off."""
    b, t = x.shape[:2]
    pad = -t % chunk
    if pad:
        x = torch.cat([x, x.new_zeros((b, pad) + tuple(x.shape[2:]))], dim=1)
    return x.reshape(b, (t + pad) // chunk, chunk, *x.shape[2:])


def chunk_groups(chunks: int, per_chunk: int, budget: int = 1 << 26):
    """Slices of a sequence's ``chunks`` chunks, each as many whole chunks
    as keep ``per_chunk`` elements a chunk under ``budget``: the batched
    VJPs take one group at a time, so their largest tensor stays ~256 MB
    of f32 whatever the sequence's length."""
    g = max(1, budget // max(per_chunk, 1))
    return [slice(c, min(c + g, chunks)) for c in range(0, chunks, g)]
