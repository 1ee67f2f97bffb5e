"""The cell's weights, made by the benchmark from the seed on the device.

One draw of standard normals from a generator of the device (its Philox
stream) fills one flat float32 buffer in a single call; each leaf is a view
of it, scaled in place by its rule: matrices ``N(0, (scale / sqrt(fan_in))^2)``
(fan-in the second to last axis), the embedding ``N(0, 0.02^2)``, and the
constants of the Mamba2 layers and the norms. The leaves' names and shapes
are the program's parameter tree (built on the meta device, nothing drawn);
the program is handed views of the buffer, and the reference reads the
same buffer by name, so neither side sees anything the other made.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

# constant leaves, by the last part of their name
CONSTANTS = {"ln": 1.0, "ln1": 1.0, "ln2": 1.0, "norm_w": 1.0, "final_norm": 1.0, "conv_b": 0.0,
             "A_log": 0.0, "D": 1.0, "dt_bias": -2.0}
EMBED_STD = 0.02


def out_scale(name: str, n_layers: int) -> float:
    """Matrices that write into the residual stream start small: the
    attention and expert output products by 1 / sqrt(2 L), the shared
    block's by 0.1 (``shared.wo``, ``shared.w_down``), Mamba2's ``w_out``
    by 1 / sqrt(2 L)."""
    leaf = name.rsplit(".", 1)[-1]
    if name.startswith("shared.") and leaf in ("wo", "w_down"):
        return 0.1
    if leaf in ("wo", "w_down", "w_out"):
        return 1.0 / math.sqrt(2 * n_layers)
    return 1.0


def rule(name: str, shape: Tuple[int, ...], n_layers: int):
    """('const', value) or ('normal', std) for leaf ``name``."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in CONSTANTS:
        return "const", CONSTANTS[leaf]
    if leaf == "embed":
        return "normal", EMBED_STD
    return "normal", out_scale(name, n_layers) / math.sqrt(shape[-2])


def draw(layout: Dict[str, Tuple[Tuple[int, ...], torch.dtype]], n_layers: int, seed: int,
         device) -> Dict[str, torch.Tensor]:
    """Every leaf of ``layout`` (name -> (shape, dtype)) as a view of one flat
    buffer drawn on ``device`` from ``seed``, in the leaves' sorted order."""
    names = sorted(layout)
    sizes = [math.prod(layout[n][0]) for n in names]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    flat.normal_(generator=gen)
    out, off = {}, 0
    for n, size in zip(names, sizes):
        shape, dtype = layout[n]
        if dtype != torch.float32:
            raise ValueError(f"{n} is stored as {dtype}; the benchmark draws float32 leaves")
        view = flat[off: off + size].view(shape)
        kind, value = rule(n, shape, n_layers)
        if kind == "const":
            view.fill_(value)
        else:
            view.mul_(value)
        out[n] = view
        off += size
    return out


def layout_of(module: torch.nn.Module) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    return {n: (tuple(p.shape), p.dtype) for n, p in module.named_parameters()}


def load_into(module: torch.nn.Module, leaves: Dict[str, torch.Tensor]) -> torch.nn.Module:
    """Put ``leaves`` into ``module`` (built on meta) as its frozen
    parameters, by name, without a copy."""
    for name, t in leaves.items():
        owner_name, _, attr = name.rpartition(".")
        owner = module.get_submodule(owner_name) if owner_name else module
        owner._parameters[attr] = torch.nn.Parameter(t, requires_grad=False)
    return module
