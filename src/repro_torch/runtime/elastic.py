"""Elastic restore: any checkpoint onto the device its template lives on
(mirrors repro/runtime/elastic.py on one device).

Checkpoints are written as full (unsharded) host arrays per leaf, so a
restore is a copy into the template's tensors wherever they lie: a
replacement host, or a card that takes over from another, restores the
same state. The data pipeline re-slices the same global cursor
(ShardedLoader.restore), so the token trajectory is unchanged across
topology changes.

Restoring onto a mesh of cards (the reference's ``mesh`` and ``specs``,
and its ``shardings_for``, which builds shardings on a JAX mesh) is
tensor sharding, ROADMAP A11.3: ``shardings_for`` is left out, and a mesh or
specs raises.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.checkpoint import CheckpointManager


def elastic_restore(
    manager: CheckpointManager,
    template: Any,
    mesh: Any = None,
    specs: Optional[Any] = None,
    step: Optional[int] = None,
):
    """Restore ``template``-shaped state onto the template's device.

    Returns (state, extras). This is the node-failure / resize recovery path:
    build the replacement host's template, call this, continue.
    """
    if mesh is not None or specs is not None:
        raise NotImplementedError("restoring onto a mesh of cards (mesh, specs) is ROADMAP A11.3")
    return manager.restore(template, step=step)
