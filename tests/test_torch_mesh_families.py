"""The port's sharded engine over a mesh of ranks for the families other
than dense, against the reference's N-device ``ShardedServingEngine``, on
the CPU.

Reduced granite-moe-3b-a800m and qwen2-moe-a2.7b (moe: 8 experts,
TP-for-MoE, the expert hidden dim over the ranks; qwen2-moe with its
shared expert and QKV bias), qwen2-vl-7b (vlm: embeds and M-RoPE positions
in), rwkv6-7b (ssm: B6 on each rank's heads), zamba2-1.2b (hybrid: B7 on
each rank's Mamba2 heads, the shared block's attention on its heads) and
whisper-base (audio: the encoder, and the cross K/V on each rank's heads),
each over 2 and 4 ``gloo`` ranks, whole-slot; qwen2-moe, rwkv6 and zamba2
also through the chunked path (``prefill_chunk=8``) over 2 (vlm and audio
never chunk). Serving with ``sp_activations`` off, device tiering on,
identity scales and the verify probe. The reference runs with 4 host
devices, one subprocess an arch running its cases in turn
(``tests/_jax_mesh_engine.py``), side by side; the port in one spawn of 4
ranks (``tests/_torch_mesh_ranks.py``), both from the same parameters.
Held: the tokens of every step on every rank, stats, live counters, role
hits and the merged drained planes bit-exact, and every rank's the same;
one prefill's logits, its input in the family's keys, within 1e-4 of
their scale; B1 once per non-empty shard a step, summed over the ranks;
each rank holding ``shape[-1] / N`` columns of every divisible leaf, and
its cache holding its share of the heads.
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

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.parity import params_from_jax  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("granite-moe-3b-a800m", "qwen2-moe-a2.7b", "qwen2-vl-7b", "rwkv6-7b", "zamba2-1.2b", "whisper-base")
CHUNKED = ("qwen2-moe-a2.7b", "rwkv6-7b", "zamba2-1.2b")
WORLD = 4
LOGIT_TOL = 1e-4
CASES = ranks.cases_of(ARCHS, WORLD, CHUNKED)
IDS = [ranks.case_id(*case) for case in CASES]


@pytest.fixture(scope="module")
def trees():
    return {arch: jax.tree.map(np.asarray, jax_model(jax_config(arch).reduced()).init(jax.random.PRNGKey(0)))
            for arch in ARCHS}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, trees):
    tmp = tmp_path_factory.mktemp("mesh_families")
    with open(tmp / "params.pkl", "wb") as f:
        pickle.dump(trees, f)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    refs = {arch: subprocess.Popen(  # one an arch, its cases in turn; the archs side by side
        [sys.executable, str(ROOT / "tests" / "_jax_mesh_engine.py"), str(tmp / "params.pkl"),
         str(tmp / f"ref_{arch}.pkl"), arch] + [f"{n}:{chunk}" for a, n, chunk in CASES if a == arch],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for arch in ARCHS}
    try:
        port = ranks.spawn(ranks.engine_run, WORLD, str(tmp / "store"),
                           {arch: params_from_jax(tree) for arch, tree in trees.items()}, False, CASES)
        logs = {arch: p.communicate(timeout=600)[0] for arch, p in refs.items()}
    finally:
        for p in refs.values():
            if p.poll() is None:
                p.kill()
    ref = {}
    for arch, p in refs.items():
        assert p.returncode == 0, logs[arch][-4000:]
        with open(tmp / f"ref_{arch}.pkl", "rb") as f:
            ref.update({(arch, *case): run for case, run in pickle.load(f).items()})
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


def _heads(cfg) -> dict:
    """Each cache leaf's heads on its axis 2: the KV and cross caches' KV
    heads, rwkv6's wkv heads, the Mamba2 SSM heads."""
    return {"k": cfg.n_kv_heads, "v": cfg.n_kv_heads, "cross_k": cfg.n_kv_heads, "cross_v": cfg.n_kv_heads,
            "wkv": cfg.d_model // cfg.ssm_head_dim, "ssm": cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim}


@pytest.mark.parametrize("arch,n,chunk", CASES, ids=IDS)
def test_each_rank_holds_its_share(runs, trees, arch, n, chunk):
    """Each rank holds ``shape[-1] / N`` columns of every leaf whose last
    axis divides N (qwen2-moe's (D, 1) shared gate stays whole); its cache
    holds its share of every leaf's heads (all of them divide here), and
    the shifts, conv tails and lengths whole."""
    port, _ = runs
    full = {k: tuple(v.shape) for k, v in params_from_jax(trees[arch]).items()}
    cfg = get_config(arch).reduced()
    whole = {k: tuple(v.shape) for k, v in get_model(cfg).init_cache(
        ranks.ENGINE["max_batch"], ranks.ENGINE["max_len"], device="cpu").items()}
    heads = _heads(cfg)
    for rank in range(n):
        got = port[rank][(arch, n, chunk)]
        assert set(got["shapes"]) == set(full)
        for name, shape in full.items():
            want = shape[:-1] + (shape[-1] // n,) if shape[-1] % n == 0 else shape
            assert got["shapes"][name] == want, name
        assert set(got["cache"]) == set(whole)
        for name, shape in whole.items():
            if name in heads:
                assert shape[2] == heads[name] and heads[name] % n == 0, name
                shape = shape[:2] + (heads[name] // n,) + shape[3:]
            assert got["cache"][name] == shape, name
