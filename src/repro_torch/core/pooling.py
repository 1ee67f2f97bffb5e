"""Cluster weight pooling — the paper's shared-L2 proposal on a mesh of cards
(mirrors repro/core/pooling.py).

Paper: four cores run identical code, so pool their four private L2s into one
shared L2 -> 4x apparent capacity, same silicon. Here: k data-parallel
replicas hold identical parameters, so store each parameter 1/k-sharded over
the ``pool`` mesh axis and gather it just in time inside the step -> k x
apparent device memory per replica, same cards.

``pooled_specs`` picks, per parameter, the largest dimension that is still
unsharded and divisible by the pool-axis size, and shards it: the same rule
and the same specs tree as the reference's. The parameters are then placed
at those specs (``launch.mesh.place_params``). Inside the step the models
gather each layer's leaves to their compute (TP) layout where the layer
runs (``common.cast`` with the leaf's spec, cast first so the gather moves
compute-dtype bytes, one layer at a time, nothing held across steps); its
backward is the reduce-scatter that keeps gradients and optimizer state
pooled (ZeRO-1/2/3 in one move). ``gather`` is that constraint for a whole
module, one leaf at a time.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.launch import mesh as meshlib
from repro_torch.launch.mesh import POOL
from repro_torch.optim.adamw import LAYER_STACK


def _is_spec(s) -> bool:
    return isinstance(s, tuple)


def _reference_shapes(abstract_params: torch.nn.Module) -> dict:
    """The module's leaf shapes as the reference's tree: nested dicts under
    its names, a layer stack (``layers.<i>.rest``) one leaf of shape
    ``(L, *layer shape)``."""
    out: dict = {}
    stacks: dict = {}
    for name, p in abstract_params.named_parameters():
        m = LAYER_STACK.match(name)
        path = (m.group(1), *name[m.end():].split(".")) if m else tuple(name.split("."))
        if m:
            stacks[path] = stacks.get(path, 0) + 1
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = tuple(p.shape)
    for path, n in stacks.items():
        node = out
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = (n,) + node[path[-1]]
    return out


def pooled_specs(compute_specs, abstract_params, mesh) -> dict:
    """Storage specs: compute specs + POOL axis on the best available dim.

    ``abstract_params``: the parameter module (``ModelAPI.abstract_params()``,
    on the meta device), its leaves read as the reference's tree (a layer
    stack one leaf). ``mesh``: anything with ``mesh_dim_names`` and
    ``shape`` (a ``DeviceMesh``). Leaves whose dims are all
    sharded/non-divisible stay at compute layout.
    """
    if POOL not in mesh.mesh_dim_names:
        return compute_specs
    k = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))[POOL]
    shapes = _reference_shapes(abstract_params)

    def one(spec, shape):
        spec = tuple(spec)
        best, best_size = None, 0
        for i, (s, dim) in enumerate(zip(spec, shape)):
            if s is None and dim % k == 0 and dim > best_size:
                best, best_size = i, dim
        if best is None:
            return spec
        out = list(spec)
        out[best] = POOL
        return tuple(out)

    def walk(specs, shapes):
        if _is_spec(specs):
            return one(specs, shapes)
        return {n: walk(s, shapes[n]) for n, s in specs.items()}

    return walk(compute_specs, shapes)


def gather(params: torch.nn.Module, compute_specs):
    """The in-step gather of pooled parameters back to their compute
    layout, one leaf at a time: yields (``state_dict`` name, the leaf placed
    at its compute spec) under the params' mesh. Nothing is held between
    leaves, so the whole gathered tree never lives on a card at once (the
    train step gathers at each layer's own site instead: ``common.cast``).
    Under autograd each gather's backward reduce-scatters the gradient back
    to the pooled layout."""
    for name, p in params.named_parameters():
        spec = meshlib.leaf_spec(compute_specs, name)
        if meshlib.is_dtensor(p):
            with meshlib.activate(p.device_mesh):
                yield name, meshlib.shard(p, *spec)
        else:
            yield name, p


def apparent_capacity_model(
    param_bytes: float, hbm_bytes: float, cluster: int, gather_bytes_per_step: Optional[float] = None
) -> dict:
    """Analytical model for benchmarks/fig13_pooling.py (IPC-vs-cache analogue).

    Returns per-replica HBM freed and the gather traffic paid, as the paper
    reports apparent-cache-size vs performance.
    """
    resident = param_bytes / cluster
    freed = param_bytes - resident
    return {
        "cluster": cluster,
        "resident_bytes": resident,
        "freed_bytes": freed,
        "apparent_capacity_x": min(cluster, hbm_bytes / max(resident, 1.0)),
        "gather_bytes": gather_bytes_per_step if gather_bytes_per_step is not None else param_bytes * (cluster - 1) / cluster,
    }
