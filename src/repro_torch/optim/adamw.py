"""AdamW with f32 state, global-norm clipping, decoupled weight decay
(mirrors repro/optim/adamw.py).

The tree is a flat dict of tensors keyed by ``state_dict`` names. The
update is functional, as the reference's: it returns new parameter and
moment tensors and changes none it was given; the caller writes the new
parameters into its module (under ``torch.no_grad()``). Every scalar
(the step, the clip scale, the bias corrections, the learning rate) stays
a tensor on the parameters' device, so an update reads nothing back to
the host.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, Optional

import torch

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


def adamw_init(params: Tree) -> dict:
    """Zero f32 moments beside each parameter (placed as it is, across a
    mesh), and step 0 (int32, on the parameters' device)."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # a DTensor keeps its placement
    dev = next(iter(params.values())).device
    return {
        "m": {n: zeros(p) for n, p in params.items()},
        "v": {n: zeros(p) for n, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


# a layer of a stack: ``layers.<i>.rest`` (whisper: ``enc_layers``, ``dec_layers``)
LAYER_STACK = re.compile(r"^(layers|enc_layers|dec_layers)\.(\d+)\.")


def leaf_order(names) -> list:
    """The reference's leaves in ``jax.tree.leaves`` order, each a list of
    ``state_dict`` names: dict keys sorted at every level of the nested
    tree, and a layer stack (``layers.<i>.rest`` for every i) one leaf, its
    layers in order."""
    leaves: Dict[tuple, list] = {}
    for name in names:
        m = LAYER_STACK.match(name)
        if m:
            path = (m.group(1), *name[m.end():].split("."))
            leaves.setdefault(path, []).append((int(m.group(2)), name))
        else:
            leaves.setdefault(tuple(name.split(".")), []).append((0, name))
    return [[n for _, n in sorted(leaves[path])] for path in sorted(leaves)]


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in f32, summed leaf by leaf
    in the reference's leaf order (``leaf_order``), a layer stack's layers
    summed into one term first."""
    total = None
    for group in leaf_order(tree):
        term = None
        for name in group:
            sq = (tree[name].float() ** 2).sum()
            term = sq if term is None else term + sq
        total = term if total is None else total + term
    return torch.sqrt(total)


def _coefficients(cfg: AdamWConfig, grads: Tree, state: dict):
    """(step, grad norm, clip scale, lr, the two bias corrections): every
    scalar of one update, each a tensor on the parameters' device."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp_min(gnorm, 1e-12), max=1.0)
    stepf = step.to(torch.float32)
    lr = cfg.lr if cfg.schedule is None else cfg.lr * cfg.schedule(step)
    return step, gnorm, scale, lr, 1.0 - cfg.b1 ** stepf, 1.0 - cfg.b2 ** stepf


def _leaf(cfg: AdamWConfig, coef, p, g, m, v):
    """One leaf's (new parameter, m, v)."""
    _, _, scale, lr, b1c, b2c = coef
    g = g.float() * scale
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * g * g
    mhat = m / b1c
    vhat = v / b2c
    delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
    return (p.float() - lr * delta).to(p.dtype), m, v


def _metrics(coef) -> dict:
    _, gnorm, _, lr, _, _ = coef
    # a constant lr becomes a tensor by a fill on the device, not a copy from the host
    lr_t = lr.float() if torch.is_tensor(lr) else torch.full((), lr, dtype=torch.float32, device=gnorm.device)
    return {"grad_norm": gnorm, "lr": lr_t}


def adamw_update(cfg: AdamWConfig, params: Tree, grads: Tree, state: dict):
    """Returns (new_params, new_state, metrics)."""
    coef = _coefficients(cfg, grads, state)
    new_p, new_m, new_v = {}, {}, {}
    for n, p in params.items():
        new_p[n], new_m[n], new_v[n] = _leaf(cfg, coef, p, grads[n], state["m"][n], state["v"][n])
    return new_p, {"m": new_m, "v": new_v, "step": coef[0]}, _metrics(coef)


def adamw_update_(cfg: AdamWConfig, params: Tree, grads: Tree, state: dict):
    """``adamw_update`` in place, one leaf at a time: each parameter and its
    moments written into their own tensors (the same values bit for bit),
    and each leaf's gradient and temporaries let go before the next, where
    the functional update holds a new copy of every parameter and moment at
    once (three more of the model's state: what a card holding a pooled
    110 B-wide model has no room for). ``grads`` is emptied. Returns (state,
    metrics), ``state`` the same dict with its step advanced."""
    coef = _coefficients(cfg, grads, state)
    with torch.no_grad():
        for n, p in params.items():
            new_p, new_m, new_v = _leaf(cfg, coef, p, grads.pop(n), state["m"][n], state["v"][n])
            p.copy_(new_p)
            state["m"][n].copy_(new_m)
            state["v"][n].copy_(new_v)
    state["step"] = coef[0]
    return state, _metrics(coef)
