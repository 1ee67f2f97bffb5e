"""Where the port runs, and the one door between host and device memory.

Every entry point takes ``device=None``. ``None`` means the CUDA card; a
process that sees no card raises instead of quietly running on the CPU.
In a rank of a process group over several cards (``launch.mesh``) the
card is the rank's own.
Tests pass ``device="cpu"`` explicitly, and there every kernel wrapper
takes its plain PyTorch version because its tensors lie on the CPU.

Host and device exchange data only through :func:`to_device` and
:func:`to_host`. Host-to-device copies (page ids, tier maps, token ids) go
through pinned memory and are issued non-blocking, so they never wait for
the device. Every device-to-host copy is counted in ``HOST_READS``: the
serving path reads back only at counter drains, at an admit's first-token
argmax and in the verify probes, and the count shows it.
"""
from __future__ import annotations

import numpy as np
import torch

# device-to-host copies made through to_host (plain ints)
HOST_READS = {"copies": 0}


def resolve_device(device=None) -> torch.device:
    """``None`` -> the CUDA card (in a rank of a process group, the rank's
    own: ``launch.mesh.rank_card``); raise when the asked-for card is
    absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is visible; pass "
            "device='cpu' explicitly to run the plain PyTorch versions"
        )
    if device is None and torch.distributed.is_available() and torch.distributed.is_initialized():
        from repro_torch.launch.mesh import rank_card

        dev = torch.device("cuda", rank_card())
    return dev


def to_device(array, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A host array as a ``dtype`` tensor on ``device`` (non-blocking on CUDA)."""
    t = torch.as_tensor(np.ascontiguousarray(array)).to(dtype)
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def stage_into(dst: torch.Tensor, array) -> torch.Tensor:
    """Copy a host array into the existing tensor ``dst`` (same shape), in
    place and non-blocking from pinned memory on CUDA: how a captured
    graph's static inputs get a step's values without moving. (The reshape
    keeps a 0-d array 0-d: ``ascontiguousarray`` gives it one axis.)"""
    t = torch.as_tensor(np.ascontiguousarray(array)).to(dst.dtype).reshape(np.shape(array))
    if dst.device.type == "cpu":
        return dst.copy_(t)
    return dst.copy_(t.pin_memory(), non_blocking=True)


def to_host(t: torch.Tensor) -> np.ndarray:
    """One counted device-to-host copy (a sync on CUDA)."""
    HOST_READS["copies"] += 1
    return t.detach().cpu().numpy()
