"""The reference's side of ``tests/test_torch_dryrun_mesh.py``: every
dry-run cell's argument bytes per device on ``pod1`` and ``pod2``, with
nothing lowered or compiled; run in its own process under
``XLA_FLAGS=--xla_force_host_platform_device_count=512``:

    python tests/_jax_dryrun_bytes.py OUT.json

A cell's arguments are ``launch/dryrun.py:run_cell``'s: the parameters at
the (pooled) storage specs, bf16 for a serving cell, AdamW's state beside
them for a train cell, the inputs at ``batch_specs`` and a decode cell's
cache at ``cache_specs``, every spec through ``_fit_spec``. The bytes of a
leaf on a device are its ``NamedSharding``'s ``shard_shape``. OUT.json maps
"mesh/arch/shape" to the sums of the parameters, the optimizer state and
the inputs, and a decode cell's cache leaf by leaf."""
import dataclasses
import json
import sys

import jax
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs import SHAPES, applicable_shapes, get_config, list_archs
from repro.launch.dryrun import _collect_params_shardings, tree_shardings
from repro.launch.mesh import activate, make_production_mesh
from repro.models.api import get_model
from repro.optim import adamw_init


def _bytes(avals, shardings) -> int:
    leaves = jax.tree.leaves(avals)
    shs = jax.tree.leaves(shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(leaves) == len(shs), (len(leaves), len(shs))
    return sum(int(np.prod(s.shard_shape(a.shape))) * a.dtype.itemsize for a, s in zip(leaves, shs))


def cell_bytes(arch: str, shape: str, multi: bool) -> dict:
    cfg = get_config(arch)
    sh = SHAPES[shape]
    if sh.kind != "train" and cfg.sp_activations:
        cfg = dataclasses.replace(cfg, sp_activations=False)
    api = get_model(cfg)
    pool = cfg.pooling_cluster if cfg.pooling_cluster > 1 else 0
    mesh = make_production_mesh(multi_pod=multi, pool=pool)
    with activate(mesh):
        aparams, p_sh, _ = _collect_params_shardings(api, mesh, pool, serve=sh.kind != "train")
        out = {"params": _bytes(aparams, p_sh), "state": 0}
        if sh.kind == "train":
            aopt = jax.eval_shape(adamw_init, aparams)
            out["state"] = _bytes(aopt, {"m": p_sh, "v": p_sh, "step": NamedSharding(mesh, P())})
        if sh.kind in ("train", "prefill"):
            abatch = api.input_specs(shape)
            out["inputs"] = _bytes(abatch, tree_shardings(mesh, api.batch_specs(shape), abatch))
            return out
        specs = api.input_specs(shape)
        cache = tree_shardings(mesh, api.cache_specs(), specs["cache"])
        out["cache"] = {k: _bytes(v, cache[k]) for k, v in specs["cache"].items()}
        out["inputs"] = _bytes(specs["tokens"], tree_shardings(mesh, api.batch_specs(shape)["tokens"], specs["tokens"]))
        return out


def main():
    assert len(jax.devices()) >= 512, jax.devices()
    out = {}
    for multi in (False, True):
        for arch in list_archs():
            for shape in applicable_shapes(get_config(arch)):
                out[f"{'pod2' if multi else 'pod1'}/{arch}/{shape}"] = cell_bytes(arch, shape, multi)
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
