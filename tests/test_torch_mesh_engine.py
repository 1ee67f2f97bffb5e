"""The port's sharded engine over a mesh of ranks against the reference's
N-device ``ShardedServingEngine``, on the CPU.

Reduced qwen2.5-3b (4 query heads over 2 KV heads: over 4 ranks the query
heads shard and the KV heads are replicated by the divisibility drop, so
each rank must pass the kernel only the KV head its queries read) and
reduced qwen1.5-110b (4/4 heads, QKV bias; both shard evenly), serving
with ``sp_activations`` off, device tiering on, identity scales and the
verify probe. The reference runs with 4 host devices, one subprocess a
case, side by side (``tests/_jax_mesh_engine.py``; its eager steps over
sharded arrays compile op by op); the port over 4 ``gloo`` ranks, then over
ranks 0 and 1 (``tests/_torch_mesh_ranks.py``), both from the same
parameters; qwen2.5-3b also through the chunked path (``prefill_chunk=8``)
over 2 and 4 ranks, against the reference's chunked engine. Held: the tokens of every step, on every rank; stats, live
counters, role hits and the merged drained planes (slot, tenant, role)
bit-exact, and every rank's the same; one prefill's logits within 1e-4 of
their scale (f32); B1 once per non-empty shard a step, summed over the
ranks; and each rank holding ``shape[-1] / N`` columns of every leaf.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import _torch_mesh_ranks as ranks  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models.api import get_model as jax_model  # noqa: E402

from repro_torch.parity import params_from_jax  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen2.5-3b", "qwen1.5-110b")
WORLD = 4
LOGIT_TOL = 1e-4
CHUNK = 8
CASES = ranks.cases_of(ARCHS, WORLD) + [("qwen2.5-3b", n, CHUNK) for n in (2, WORLD)]
IDS = [ranks.case_id(*case) for case in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_engine")
    trees = {arch: jax.tree.map(np.asarray, jax_model(jax_config(arch).reduced()).init(jax.random.PRNGKey(0)))
             for arch in ARCHS}
    with open(tmp / "params.pkl", "wb") as f:
        pickle.dump(trees, f)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    out = lambda case: tmp / "ref_{}_{}_{}.pkl".format(*case)
    refs = {case: subprocess.Popen(  # one a case, side by side
        [sys.executable, str(ROOT / "tests" / "_jax_mesh_engine.py"), str(tmp / "params.pkl"),
         str(out(case)), case[0], f"{case[1]}:{case[2]}"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for case in CASES}
    try:
        port = ranks.spawn(ranks.engine_run, WORLD, str(tmp / "store"),
                           {arch: params_from_jax(tree) for arch, tree in trees.items()}, False, CASES)
        logs = {case: p.communicate(timeout=300)[0] for case, p in refs.items()}
    finally:
        for p in refs.values():
            if p.poll() is None:
                p.kill()
    ref = {}
    for case, p in refs.items():
        assert p.returncode == 0, logs[case][-4000:]
        with open(out(case), "rb") as f:
            ref[case] = pickle.load(f)[case[1:]]
    return port, ref


@pytest.mark.parametrize("arch,n,chunk", CASES, ids=IDS)
def test_tokens_and_books_equal_the_reference(runs, arch, n, chunk):
    ranks.check_tokens_and_books(*runs, (arch, n, chunk), WORLD)


@pytest.mark.parametrize("arch,n,chunk", CASES, ids=IDS)
def test_prefill_logits_within_tolerance(runs, arch, n, chunk):
    ranks.check_prefill_logits(*runs, (arch, n, chunk), LOGIT_TOL)


@pytest.mark.parametrize("arch,n,chunk", CASES, ids=IDS)
def test_one_b1_launch_per_non_empty_shard(runs, arch, n, chunk):
    ranks.check_one_b1_launch_per_non_empty_shard(runs[0], (arch, n, chunk))


@pytest.mark.parametrize("arch,n,chunk", CASES, ids=IDS)
def test_each_rank_holds_its_share(runs, arch, n, chunk):
    """Every leaf of these reduced configs divides N: each rank holds its
    ``shape[-1] / N`` columns; the cache holds the rank's KV heads, all of
    them where the heads do not divide (qwen2.5-3b's 2 over 4 ranks)."""
    port, _ = runs
    cfg = jax_config(arch).reduced()
    full = {k: tuple(v.shape) for k, v in params_from_jax(
        jax.tree.map(np.asarray, jax_model(cfg).init(jax.random.PRNGKey(0)))).items()}
    kv_local = cfg.n_kv_heads // n if cfg.n_kv_heads % n == 0 else cfg.n_kv_heads
    for rank in range(n):
        got = port[rank][(arch, n, chunk)]
        assert set(got["shapes"]) == set(full)
        for name, shape in full.items():
            assert got["shapes"][name] == shape[:-1] + (shape[-1] // n,), name
        assert got["cache"]["k"][2] == kv_local
