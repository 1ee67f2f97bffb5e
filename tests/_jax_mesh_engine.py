"""The reference's N-device sharded engine, the oracle of
``tests/test_torch_mesh_engine.py``; run in its own process under
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (as the reference's
CI runs its sharded tests):

    python tests/_jax_mesh_engine.py PARAMS.pkl OUT.pkl ARCH N:CHUNK [N:CHUNK ...]

(``sp_activations`` off, as serving cells run; ``run(..., sp=True)``
keeps the config's sequence-parallel attention on.)

PARAMS.pkl maps each arch to its parameter tree (numpy leaves). For ARCH
over N devices with ``prefill_chunk=CHUNK``, each case in turn: tokens a
step, stats, live counters, role hits, the merged drained planes, and one
prefill's logits under the mesh, its input in the family's keys as the
engine builds it (``_prefill_batch``: embeds and M-RoPE positions for vlm,
tokens and frames for audio). OUT.pkl maps each (N, CHUNK) to its run."""
import dataclasses
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.configs.workloads import get_profile
from repro.data.requests import RequestGenerator
from repro.launch.mesh import activate, make_serving_mesh, shard_model_params
from repro.models.api import get_model
from repro.runtime.serving import EngineConfig
from repro.runtime.sharded import ShardedServingEngine

sys.path.insert(0, __file__.rsplit("/", 1)[0])
from _torch_mesh_ranks import ENGINE, N_REQUESTS, PROMPT  # noqa: E402


def run(arch: str, tree: dict, n: int, chunk: int, sp: bool = False) -> dict:
    cfg = dataclasses.replace(get_config(arch).reduced(), sp_activations=sp)
    api = get_model(cfg)
    params = jax.tree.map(jnp.asarray, tree)
    eng = ShardedServingEngine(api, params, EngineConfig(**ENGINE, model_shards=n, prefill_chunk=chunk), seed=0)
    merged = {"near": 0, "far": 0, "slot": 0, "tenant": 0, "role": 0}
    drain = eng.tiered.drain_counters

    def counted(discard=False):
        d = drain(discard=discard)
        for k in merged:
            merged[k] = merged[k] + np.asarray(d[k], np.int64) if k in ("slot", "tenant", "role") \
                else merged[k] + d[k]
        return d

    eng.tiered.drain_counters = counted
    prof = dataclasses.replace(get_profile("Web1"), prompt_mean=24, decode_mean=8, prefix_share=0.5,
                               n_prefixes=2)
    gen = RequestGenerator(prof, vocab_size=cfg.vocab_size, seed=0)
    for _ in range(N_REQUESTS):
        eng.submit(next(gen))
    tokens = []
    while (eng.queue or any(s.active for s in eng.slots)) and eng.engine_steps < 400:
        eng.step()
        tokens.append(np.asarray(eng.next_tokens).copy())
    st = eng.stats()
    mesh = make_serving_mesh(n)
    with activate(mesh):
        logits, _ = api.prefill(shard_model_params(params, mesh), eng._prefill_batch(PROMPT), max_len=64)
    return {"tokens": np.array(tokens), "stats": st, "live": eng.live_counters(),
            "role": np.asarray(eng.role_hits).copy(), "merged": merged, "logits": np.asarray(logits),
            "shard_rows": (eng.metrics.total("shard_near_hits"), eng.metrics.total("shard_far_hits"))}


def main():
    with open(sys.argv[1], "rb") as f:
        trees = pickle.load(f)
    arch = sys.argv[3]
    cases = [tuple(int(x) for x in case.split(":")) for case in sys.argv[4:]]
    assert len(jax.devices()) >= max(n for n, _ in cases), jax.devices()
    out = {(n, chunk): run(arch, trees[arch], n, chunk) for n, chunk in cases}
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main()
