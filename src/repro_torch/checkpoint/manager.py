"""Fault-tolerant checkpointing: atomic, async, restore in place (mirrors
repro/checkpoint/manager.py, and writes its on-disk layout byte for byte).

Layout (one directory per step):
    <dir>/step_000123.tmp/      # written first
        meta.json               # step, tree description, shapes/dtypes, extras
        arr_00000.npy ...       # one file per leaf
    <dir>/step_000123/          # atomic rename AFTER meta.json is fsynced

Crash-safety: a checkpoint either has its final name (complete) or is a
.tmp orphan (ignored + GC'd). ``save_async`` snapshots to host memory
synchronously and writes on a background thread, so the train loop
overlaps I/O with compute.

The leaves are the reference's, in ``jax.tree.flatten``'s order: a model
(``nn.Module``) gives its parameters with dict keys sorted at every level
and each layer stack (``layers``, ``enc_layers``, ``dec_layers``) as one
leaf of shape (L, ...); a dict gives its values by sorted key, a flat dict
of ``state_dict`` names (AdamW's ``m`` and ``v``) grouped as the model's
parameters; a tuple or list gives its items in order. Every leaf is a
tensor of a type numpy holds (every parameter is f32). ``meta.json``'s
``treedef`` holds the port's own description of the tree (its leaf paths)
where the reference writes JAX's ``PyTreeDef``; both packages' ``restore``
read only the leaf count, so a checkpoint written by either restores into
the other.

The snapshot copies every leaf to the host through ``device.to_host``. A
leaf on the CPU is copied too: the train step writes the parameters in
place, and the background writer must save this step's values, not the
next step's. ``restore`` writes each leaf into the template's tensor in
place (a parameter's held casts see the version bump and cast anew).
Restore before an engine captures CUDA graphs over the parameters: a
captured graph holds the old casts' storage.

Across a mesh (a state whose leaves are DTensors, ``launch.mesh``): the
snapshot gathers every leaf whole (a collective, on every rank of the
mesh), one rank of the mesh writes, and the others wait for it at the end
of the save (or at ``wait`` after ``save_async``); the files are the same
full arrays as from one device. ``restore`` writes into a DTensor leaf's
local shard the rows its placement gives this rank, each rank reading only
its own slice of each file, so a checkpoint written from any mesh, or from
one device, restores onto any other.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.device import stage_into, to_host
from repro_torch.launch import mesh as meshlib
from repro_torch.optim.adamw import LAYER_STACK, leaf_order


def _flatten(tree, path: str = "") -> list:
    """The tree's leaves in the reference's order, as (path, tensors,
    stacked): a layer stack holds its layers' tensors in layer order."""
    if isinstance(tree, nn.Module):
        return _flatten(tree.state_dict(keep_vars=True), path)
    if isinstance(tree, dict):
        out = []
        for group in leaf_order(tree):
            if LAYER_STACK.match(group[0]):
                out.append((path + LAYER_STACK.sub(r"\1.*.", group[0]), [tree[n] for n in group], True))
            else:
                out += _flatten(tree[group[0]], f"{path}{group[0]}.")
        return out
    if isinstance(tree, (tuple, list)):
        return [leaf for i, t in enumerate(tree) for leaf in _flatten(t, f"{path}{i}.")]
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"checkpoint leaf {path.rstrip('.')!r} is a {type(tree).__name__}, not a tensor")
    return [(path.rstrip("."), [tree], False)]


def _describe(leaves: list) -> str:
    return "repro_torch leaves (" + ", ".join(p for p, _, _ in leaves) + ")"


def _host(tensors: list, stacked: bool) -> np.ndarray:
    """One leaf as a host array that shares no memory with the live tensors
    (a DTensor gathered whole first)."""
    if stacked:
        return to_host(torch.stack([meshlib.whole(t.detach()) for t in tensors]))
    t = tensors[0]
    host = to_host(meshlib.whole(t.detach()))
    return host.copy() if t.device.type == "cpu" and not meshlib.is_dtensor(t) else host


def _writes(mesh) -> bool:
    """Whether this rank writes a state on ``mesh``: the mesh's first rank
    (every rank, with no mesh)."""
    return mesh is None or all(c == 0 for c in mesh.get_coordinate())


def _barrier(mesh):
    """Every rank of ``mesh`` waits for the others: one barrier along each
    of its axes."""
    for i in range(mesh.ndim):
        torch.distributed.barrier(group=mesh.get_group(i))


def _sharding_leaves(tree) -> list:
    """A tree of ``launch.mesh.NamedSharding`` leaves, in the reference's
    leaf order (dict keys sorted, tuples in order)."""
    if isinstance(tree, meshlib.NamedSharding):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _sharding_leaves(tree[k])]
    return [leaf for t in tree for leaf in _sharding_leaves(t)]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._mesh = None  # the mesh of a save whose ranks have not met since
        self.gc_orphans()

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def gc_orphans(self):
        for name in os.listdir(self.dir):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        steps = [
            int(n.split("_")[1])
            for n in os.listdir(self.dir)
            if n.startswith("step_") and not n.endswith(".tmp")
        ]
        return max(steps) if steps else None

    # ------------------------------------------------------------------
    def _write(self, step: int, leaves: list, treedef_str: str, extras: dict):
        tmp = self._step_dir(step) + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        meta = {
            "step": step,
            "treedef": treedef_str,
            "n_leaves": len(leaves),
            "dtypes": [str(l.dtype) for l in leaves],
            "shapes": [list(l.shape) for l in leaves],
            "extras": extras,
        }
        for i, leaf in enumerate(leaves):
            np.save(os.path.join(tmp, f"arr_{i:05d}.npy"), leaf)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        final = self._step_dir(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1])
            for n in os.listdir(self.dir)
            if n.startswith("step_") and not n.endswith(".tmp")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def _snapshot(self, state: Any):
        """(host leaves, tree description, mesh): the device-to-host copy;
        across a mesh every rank gathers, and only the writing rank keeps
        the leaves (None elsewhere)."""
        leaves = _flatten(state)
        mesh = meshlib.mesh_of(t for _, tensors, _ in leaves for t in tensors)
        host = [_host(t, stacked) for _, t, stacked in leaves]
        return (host if _writes(mesh) else None), _describe(leaves), mesh

    # ------------------------------------------------------------------
    def save(self, step: int, state: Any, extras: Optional[dict] = None):
        """Synchronous atomic save (state: a model, dicts, tuples of tensors)."""
        self.wait()
        host, td, mesh = self._snapshot(state)
        if host is not None:
            self._write(step, host, td, extras or {})
        if mesh is not None:
            _barrier(mesh)

    def save_async(self, step: int, state: Any, extras: Optional[dict] = None):
        """Snapshot synchronously, write in the background."""
        self.wait()
        host, td, self._mesh = self._snapshot(state)
        if host is None:
            return
        ex = extras or {}

        def _worker():
            try:
                self._write(step, host, td, ex)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_worker, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._mesh is not None:
            mesh, self._mesh = self._mesh, None
            _barrier(mesh)
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------------
    def restore(self, template: Any, step: Optional[int] = None, shardings: Any = None):
        """Restore into ``template``'s tensors, in place, on their devices.

        ``template`` is the trainer's ``(model, opt_state)``, or a model
        alone for a serving checkpoint. Returns (template, extras). A
        DTensor leaf takes the rows its placement gives this rank, read
        from its file alone (the elastic reshard: any mesh wrote it).
        ``shardings``, a tree of ``launch.mesh.NamedSharding`` shaped as the
        template (``runtime.elastic.shardings_for``), is each leaf's
        placement, which the template's leaves must already have.
        """
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        leaves = [np.load(os.path.join(d, f"arr_{i:05d}.npy"), mmap_mode="r") for i in range(meta["n_leaves"])]
        t_leaves = _flatten(template)
        if len(t_leaves) != len(leaves):
            raise ValueError(f"checkpoint/template leaf mismatch: {len(leaves)} leaves in {d}, "
                             f"{len(t_leaves)} in the template")
        if shardings is not None:
            sh = _sharding_leaves(shardings)
            if len(sh) != len(t_leaves):
                raise ValueError(f"{len(sh)} shardings for {len(t_leaves)} template leaves")
            for (path, tensors, stacked), s in zip(t_leaves, sh):
                spec = meshlib.layer_spec(s.spec) if stacked else s.spec  # a stack's, less its layer axis
                for t in tensors:
                    if t.ndim == 0 and not meshlib.is_dtensor(t):
                        continue  # AdamW's step: a plain tensor on every rank
                    want = meshlib.placements(s.mesh, spec, t.shape)
                    got = list(t.placements) if meshlib.is_dtensor(t) else None
                    if got != want or t.device_mesh != s.mesh:
                        raise ValueError(f"template leaf {path} is placed {got}, its sharding says {want}: "
                                         "place the template on the mesh first (runtime.elastic)")
        with torch.no_grad():
            for (path, tensors, stacked), leaf in zip(t_leaves, leaves):
                parts = list(leaf) if stacked else [leaf]
                t = tensors[0]
                if len(parts) != len(tensors) or any(tuple(x.shape) != p.shape or str(x.dtype) != f"torch.{p.dtype}"
                                                     for x, p in zip(tensors, parts)):
                    raise ValueError(f"checkpoint leaf {path}: {leaf.dtype} {list(leaf.shape)} does not fit the "
                                     f"template's {len(tensors)} x {t.dtype} {list(t.shape)}")
                for t, part in zip(tensors, parts):
                    if meshlib.is_dtensor(t):
                        idx = meshlib.local_index(t.shape, t.device_mesh, t.placements)
                        stage_into(t.to_local(), np.array(part[idx]))  # this rank's slice, read
                    else:
                        stage_into(t, np.array(part))
        return template, meta["extras"]
