"""The reference's train step across devices, the oracle of
``tests/test_torch_mesh_train.py``; run in its own process under
``XLA_FLAGS=--xla_force_host_platform_device_count=4``:

    python tests/_jax_mesh_train.py IN.pkl OUT.pkl

IN.pkl holds ``cases``, each (arch, mesh shape over ("data", "pool",
"model"), rows, sequence), ``trees`` (arch -> the initial parameters,
numpy leaves), ``batches`` (arch -> the family's batch: ``labels`` and
``tokens``, ``embeds`` and ``mrope_positions``, or ``tokens`` and
``frames``), ``opt`` (AdamW's
keyword arguments) and ``engine`` ("ARCH:sp", N): one serving case with
``sp_activations`` on. For each train case: the reference's
``make_train_step(api, AdamWConfig(**opt), storage_specs=pooled_specs)``,
jitted with the placements of ``launch/dryrun.py:run_cell`` (parameters and
moments at the pooled specs, the batch at the model's ``batch_specs``
of a train cell), two steps on the
one batch: each step's metrics, the final parameters and moments, and each
leaf's shard shape; and the final parameters and moments of the same two
steps jitted on one device; for each arch and mesh shape, ``pooled_specs`` at full
size. ``grad_accum`` (arch -> micro-batches) overrides a reduced config's.
The mesh takes Auto axes (``Mesh`` over the devices, as
``make_serving_mesh`` builds its own): ``jax.make_mesh``'s Explicit axes
refuse the reference's sharding constraints. OUT.pkl maps ``train``,
``specs`` and ``engine`` to those."""
import dataclasses
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from repro.configs import get_config
from repro.core import pooling
from repro.launch.dryrun import tree_shardings
from repro.launch.mesh import activate
from repro.models.api import get_model, make_train_step
from repro.optim import AdamWConfig, adamw_init

sys.path.insert(0, __file__.rsplit("/", 1)[0])
import _jax_mesh_engine  # noqa: E402

AXES = ("data", "pool", "model")


def mesh_of(shape) -> Mesh:
    return Mesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape), AXES)


def train(arch: str, shape, tree: dict, batch: dict, opt: dict, grad_accum=None) -> dict:
    cfg = get_config(arch).reduced()
    api = get_model(cfg if grad_accum is None else dataclasses.replace(cfg, grad_accum=grad_accum))
    mesh = mesh_of(shape)
    with activate(mesh):
        aparams = api.abstract_params()
        specs = pooling.pooled_specs(api.param_specs(), aparams, mesh)
        p_sh = tree_shardings(mesh, specs, aparams)
        o_sh = {"m": p_sh, "v": p_sh, "step": NamedSharding(mesh, P())}
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        b_sh = tree_shardings(mesh, api.batch_specs("train_4k"), batch)
        step = jax.jit(make_train_step(api, AdamWConfig(**opt), storage_specs=specs),
                       in_shardings=(p_sh, o_sh, b_sh), out_shardings=(p_sh, o_sh, None))
        params = jax.device_put(jax.tree.map(jnp.asarray, tree), p_sh)
        state = jax.device_put(adamw_init(params), o_sh)
        metrics = []
        for _ in range(2):
            params, state, m = step(params, state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        host = lambda t: jax.tree.map(np.asarray, t)
    # the same two steps on one device: the reference's own spread between
    # two summation orders
    plain = jax.jit(make_train_step(api, AdamWConfig(**opt)))
    pp = jax.tree.map(jnp.asarray, tree)
    ps = adamw_init(pp)
    for _ in range(2):
        pp, ps, _ = plain(pp, ps, batch)
    return {"metrics": metrics, "params": host(params), "m": host(state["m"]), "v": host(state["v"]),
            "plain": {"params": host(pp), "m": host(ps["m"]), "v": host(ps["v"])},
            "shards": jax.tree.map(lambda x: tuple(x.sharding.shard_shape(x.shape)), params),
            "specs": specs}


def full_specs(arch: str, shape) -> dict:
    api = get_model(get_config(arch))
    mesh = mesh_of(shape)
    return pooling.pooled_specs(api.param_specs(), api.abstract_params(), mesh)


def main():
    with open(sys.argv[1], "rb") as f:
        inp = pickle.load(f)
    assert len(jax.devices()) >= 4, jax.devices()
    out = {"train": {}, "specs": {}}
    for arch, shape, _, _ in inp["cases"]:
        out["train"][(arch, shape)] = train(arch, shape, inp["trees"][arch], inp["batches"][arch], inp["opt"],
                                            inp["grad_accum"].get(arch))
        out["specs"][(arch, shape)] = full_specs(arch, shape)
    arch, n = inp["engine"]  # "ARCH:sp"
    base = arch.partition(":")[0]
    out["engine"] = _jax_mesh_engine.run(base, inp["trees"][base], n, 0, sp=True)
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main()
