"""Elastic scaling: restore any checkpoint onto any mesh (mirrors
repro/runtime/elastic.py).

Checkpoints are written as full (unsharded) host arrays per leaf, so a
restore is a copy of each rank's slice into the template's tensors placed
on the NEW mesh: shrink from four cards to two, grow back, change the
pool-axis factorization, or come down to one plain device, and the training
state lands correctly re-sharded. The data pipeline re-slices the same
global cursor (ShardedLoader.restore), so the token trajectory is unchanged
across topology changes.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import mesh as meshlib


def _is_spec(s) -> bool:
    return isinstance(s, tuple) and all(x is None or isinstance(x, (str, tuple)) for x in s)


def shardings_for(mesh, specs: Any):
    """Tree of partition-spec tuples -> ``launch.mesh.NamedSharding``s on
    ``mesh`` (axes not present in the mesh are dropped; non-divisible dims
    fall back to replicated on that axis via the spec filter)."""
    if _is_spec(specs):
        return meshlib.named(mesh, *specs)
    if isinstance(specs, dict):
        return {k: shardings_for(mesh, v) for k, v in specs.items()}
    return type(specs)(shardings_for(mesh, v) for v in specs)


def place(template: Any, mesh, specs: Any):
    """``template`` (a model, dicts keyed by ``state_dict`` names or by the
    reference's keys, tuples; as a checkpoint holds them) placed on
    ``mesh`` at ``specs``, a tree shaped as the template with the
    reference's specs trees for its models (``launch.mesh.leaf_spec``).
    Each rank copies only its slices; a 0-d leaf (AdamW's step) stays a
    plain tensor on the mesh's device."""
    if isinstance(template, torch.nn.Module):
        return meshlib.place_params(template, mesh, specs)
    if isinstance(template, dict):
        out = {}
        for n, t in template.items():
            if isinstance(t, torch.Tensor):
                spec = meshlib.leaf_spec(specs, n)
                out[n] = t.detach().to(meshlib.mesh_device(mesh), copy=True) if t.ndim == 0 \
                    else meshlib.distribute(t, mesh, spec)
            else:
                out[n] = place(t, mesh, specs[n])
        return out
    return type(template)(place(t, mesh, s) for t, s in zip(template, specs))


def elastic_restore(
    manager: CheckpointManager,
    template: Any,
    mesh: Any = None,
    specs: Optional[Any] = None,
    step: Optional[int] = None,
):
    """Restore ``template``-shaped state onto ``mesh`` (None = the template's
    own device, or its own placement where its leaves are DTensors).

    With ``mesh`` and ``specs`` the template is first placed on the mesh
    (:func:`place`, whatever device it was on), then every rank reads its
    own slice of each leaf. Returns (state, extras). This is the
    node-failure / resize recovery path: build a fresh mesh from the
    surviving hosts, call this, continue.
    """
    sh = None
    if mesh is not None and specs is not None:
        template = place(template, mesh, specs)
        sh = shardings_for(mesh, specs)
    return manager.restore(template, step=step, shardings=sh)
