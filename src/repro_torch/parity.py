"""Carry the reference's parameters into the port, and compare results.

``params_from_jax`` takes the JAX package's parameter tree with its leaves
already converted to numpy (``jax.tree.map(np.asarray, params)``), so this
module needs no JAX. Layer leaves are stacked on a leading L axis there and
split onto ``layers.<i>`` here (whisper's ``enc_layers`` and ``dec_layers``
onto ``enc_layers.<i>`` and ``dec_layers.<i>``), and nested subtrees (the moe family's
``experts`` and ``shared``) keep their paths; the result loads with the
port's model's ``load_state_dict(..., strict=True)``. ``tree_from_state``
goes the other way, for gradients held against ``jax.grad``'s.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: same bits as torch's
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = val
    return out


# the reference's subtrees stacked on a leading layer axis
_STACKS = ("layers", "enc_layers", "dec_layers")


def params_from_jax(tree: dict) -> Dict[str, torch.Tensor]:
    """Reference param tree (numpy leaves) -> state_dict of the port's model."""
    state: Dict[str, torch.Tensor] = {}
    for name, leaf in _flatten(tree).items():
        stack, _, rest = name.partition(".")
        if stack in _STACKS and rest:
            for i in range(np.asarray(leaf).shape[0]):
                state[f"{stack}.{i}.{rest}"] = _tensor(np.asarray(leaf)[i])
        else:
            state[name] = _tensor(leaf)
    return state


def tree_from_state(state: Dict[str, torch.Tensor]) -> dict:
    """The inverse of ``params_from_jax``, for a gradient (or parameter)
    dict keyed by ``state_dict`` names: ``layers.<i>.*`` (and whisper's
    stacks) stacked back onto a leading L axis, dotted names nested, every
    leaf numpy (bf16 as f32), so that each leaf lines up with the
    reference's tree (``jax.grad``'s)."""
    tree: dict = {}
    stacked: Dict[tuple, Dict[int, np.ndarray]] = {}

    def host(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    for name, t in state.items():
        stack, _, rest = name.partition(".")
        idx, _, leaf = rest.partition(".")
        if stack in _STACKS and idx.isdigit():
            stacked.setdefault((stack, *leaf.split(".")), {})[int(idx)] = host(t)
        else:
            stacked[tuple(name.split("."))] = {-1: host(t)}
    for path, parts in stacked.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = parts[-1] if -1 in parts else np.stack([parts[i] for i in sorted(parts)])
    return tree


def assert_close(actual, expected, *, atol: float, rtol: float = 0.0, what: str = ""):
    """Elementwise |actual - expected| <= atol + rtol * |expected|, on numpy
    copies of tensors or arrays (bf16 compared as f32)."""

    def host(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu()
            return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
        x = np.asarray(x)
        return x.astype(np.float32) if x.dtype.name == "bfloat16" else x

    a, e = host(actual), host(expected)
    if a.shape != e.shape:
        raise AssertionError(f"{what}: shape {a.shape} != {e.shape}")
    np.testing.assert_allclose(a, e, atol=atol, rtol=rtol, err_msg=what)
