"""The port's mesh layer (``repro_torch.launch.mesh``) against the
reference's semantics (``tests/test_sharding.py``), and its specs trees
against the reference's.

1. In one process: ``shard`` is the identity without a mesh; the
   production mesh's shapes; every family's specs trees (``param_specs``,
   ``cache_specs``, ``batch_specs`` and the per-layer ones the models
   constrain at) equal the reference's for every config, with
   ``sp_activations`` on and off.
2. Over 4 ``gloo`` ranks meeting at a ``file://`` store (one spawn):
   ``make_host_mesh`` and ``make_serving_mesh`` bounds raise, ``spec``
   filters missing axes, the divisibility drop, ``shard_model_params``
   bit-identical on one rank and, over 2 and 4 ranks, each rank holding
   ``shape[-1] / N`` columns of every divisible leaf; the held casts of a
   placed layer at its compute specs; ``rms_norm`` of a D-sharded residual
   and ``matmul_f32`` across the plain/DTensor boundary; and an attention
   layer of 16 query heads over 2 KV heads on 4 ranks (each rank's 4 query
   heads must read only their KV head: all of them would group by 2 and
   pair the heads wrongly, with no error) against the same layer on one
   device.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import _torch_mesh_ranks as ranks  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import list_archs as jax_archs  # noqa: E402
from repro.configs.base import applicable_shapes  # noqa: E402
from repro.launch import mesh as jax_mesh  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import mamba2 as jax_mamba2  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.models import rwkv6 as jax_rwkv6  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.models import whisper as jax_whisper  # noqa: E402
from repro.models import zamba2 as jax_zamba2  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import mesh as meshlib  # noqa: E402
from repro_torch.models import api, attention, mamba2, moe, rwkv6, transformer, whisper, zamba2  # noqa: E402

WORLD = 4

# ---------------------------------------------------------------------------
# 1. in one process


def test_shard_is_noop_without_mesh():
    x = torch.ones(4, 8)
    assert meshlib.active_mesh() is None
    assert meshlib.shard(x, "data", "model") is x
    assert meshlib.spec(("pod", "data"), "model", None) == (("pod", "data"), "model", None)


def test_axis_names_are_the_reference():
    assert (meshlib.BATCH, meshlib.MODEL, meshlib.POOL) == (jax_mesh.BATCH, jax_mesh.MODEL, jax_mesh.POOL)


@pytest.mark.parametrize("multi_pod,pool", [(False, 0), (True, 0), (False, 4), (True, 2)])
def test_production_mesh_shapes(multi_pod, pool):
    shape, axes = meshlib.production_mesh_shape(multi_pod=multi_pod, pool=pool)
    assert int(torch.tensor(shape).prod()) == (512 if multi_pod else 256)
    assert axes[-1] == "model" and shape[-1] == 16 and len(shape) == len(axes)
    assert ("pool" in axes) == bool(pool) and ("pod" in axes) == multi_pod


def _configs():
    for arch in jax_archs():
        for reduced in (False, True):
            for sp in (False, True):
                yield arch, reduced, sp


def _pair(arch, reduced, sp):
    rc, pc = jax_config(arch), get_config(arch)
    if reduced:
        rc, pc = rc.reduced(), pc.reduced()
    return dataclasses.replace(rc, sp_activations=sp), dataclasses.replace(pc, sp_activations=sp)


@pytest.mark.parametrize("arch,reduced,sp", list(_configs()))
def test_specs_trees_equal_reference(arch, reduced, sp):
    rc, pc = _pair(arch, reduced, sp)
    ref, port = jax_api.get_model(rc), api.get_model(pc)
    assert port.family == ref.family
    assert port.param_specs() == ref.param_specs()
    assert port.cache_specs() == ref.cache_specs()
    for shape in applicable_shapes(rc):
        assert port.batch_specs(shape) == ref.batch_specs(shape), shape
    fam = ref.family
    assert attention.param_specs(pc) == jax_attention.param_specs(rc)
    for axis in (1, 2, 4, 16):
        assert attention.cache_specs(pc, axis) == jax_attention.cache_specs(rc, axis)
    if fam in ("dense", "vlm"):
        assert transformer.layer_specs(pc) == jax_transformer.layer_specs(rc)
    if fam == "moe":
        for axis in (4, 16):
            assert moe.layer_specs(pc, axis) == jax_moe.layer_specs(rc, axis)
            assert moe.param_specs(pc, axis) == jax_moe.param_specs(rc, axis)
    if fam == "ssm":
        assert rwkv6.layer_specs(pc) == jax_rwkv6.layer_specs(rc)
    if fam == "hybrid":
        assert mamba2.block_specs(pc) == jax_mamba2.block_specs(rc)
        assert zamba2.shared_specs(pc) == jax_zamba2.shared_specs(rc)
        for axis in (2, 16):
            assert zamba2.cache_specs(pc, axis) == jax_zamba2.cache_specs(rc, axis)
    if fam == "audio":
        assert whisper.enc_layer_specs(pc) == jax_whisper.enc_layer_specs(rc)
        assert whisper.dec_layer_specs(pc) == jax_whisper.dec_layer_specs(rc)


# ---------------------------------------------------------------------------
# 2. over gloo ranks


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    store = str(tmp_path_factory.mktemp("mesh") / "store")
    return ranks.spawn(ranks.mesh_checks, WORLD, store)


def test_mesh_bounds_raise(rank_results):
    for res in rank_results:
        assert "divide" in res["host_0"] and "divide" in res["host_3"] and "divide" in res[f"host_{2 * WORLD}"]
        assert "devices" in res["serving_0"] and "devices" in res[f"serving_{WORLD + 1}"]
        assert res["host_shape"] == (WORLD, 1)
        assert res["serving_shape"] == {1: (1,), 2: (2,), WORLD: (WORLD,)}


def test_spec_filters_missing_axes(rank_results):
    for res in rank_results:
        assert res["spec"] == (("data",), "model", None)
        assert res["named"] == ("model", ("data",)) and res["tree"] == (None,)


def test_shard_noop_and_divisibility_drop(rank_results):
    for res in rank_results:
        assert res["noop_without_mesh"] and res["noop_on_plain"]
        assert res["drop"] == ["Replicate()"]  # neither 3 nor 5 splits 4 ways
        placements, local, same = res["kept"]
        assert placements == ["Shard(dim=1)"] and local == (3, 8 // WORLD) and same


def test_shard_model_params_one_rank_bit_identical(rank_results):
    assert rank_results[0]["identical"]
    placed = rank_results[0]["placed"][(1, "tree")]
    assert all(p == ["Replicate()"] and same for _, p, _, same in placed.values())


@pytest.mark.parametrize("n", [2, WORLD])
def test_each_rank_holds_its_columns(rank_results, n):
    """Each rank holds ``shape[-1] / N`` columns of every divisible leaf
    (every leaf of reduced qwen2.5-3b divides), the rest replicated, and
    the shards reassemble the leaf."""
    for rank, res in enumerate(rank_results[:n]):
        tree = res["placed"][(n, "tree")]
        assert tree["w"][:2] == ((3, 4 // n), ["Shard(dim=1)"])
        assert tree["b"][:2] == ((5,), ["Replicate()"]) and tree["odd"][:2] == ((3,), ["Replicate()"])
        assert tree["sub.m"][:2] == ((6, 8 // n), ["Shard(dim=1)"])
        model = res["placed"][(n, "model")]
        ref = {k: v for k, v in rank_results[0]["placed"][(1, "model")].items()}
        for name, (local, placements, device, same) in model.items():
            full = ref[name][0]
            assert same and device == "cpu", name
            assert placements == [f"Shard(dim={len(full) - 1})"], name
            assert local == full[:-1] + (full[-1] // n,), name
    for res in rank_results[n:]:
        assert (n, "model") not in res["placed"]


@pytest.mark.parametrize("n", [1, 2, WORLD])
def test_held_casts_take_the_compute_specs(rank_results, n):
    """A placed layer's casts sit at ``layer_specs``: q/k/v columns and
    their biases over ``MODEL``, ``wo`` by rows, held across calls."""
    placements, held, bf16 = rank_results[0]["casts"][n]
    assert held and bf16
    assert placements["wq"] == placements["wk"] == ["Shard(dim=1)"]
    assert placements["wo"] == ["Shard(dim=0)"] and placements["bq"] == ["Shard(dim=0)"]


def test_norm_and_products_across_the_boundary(rank_results):
    for res in rank_results:
        assert res["rms_sharded"] < 1e-6
        assert res["matmul_col"] < 1e-5
        placements, err = res["matmul_row"]
        assert placements == ["Replicate()"] and err < 1e-5


def test_attention_on_local_heads_reads_its_kv_head(rank_results):
    for res in rank_results:
        gqa = res["gqa"]
        assert gqa["kv_heads"] == 2  # replicated: 2 KV heads do not split 4 ways
        assert gqa["prefill"] < 1e-5 and gqa["decode"] < 1e-5 and gqa["cache"] == 0.0, gqa


def test_init_cache_holds_this_ranks_heads(rank_results):
    """``init_cache(mesh=)``: every leaf whose heads go over ``MODEL`` (the KV
    and cross caches, rwkv6's wkv state, the Mamba2 SSM state) holds this
    rank's share of its heads on axis 2 (all of them where the ranks do not
    divide them: qwen2.5-3b's 2 KV heads over 4), the rest whole, one arch
    a family; a 1-card mesh's cache is the unsharded one."""
    heads = {"k", "v", "cross_k", "cross_v", "wkv", "ssm"}
    for n in (1, 2, WORLD):
        for rank, res in enumerate(rank_results[:n]):
            for arch in ranks.FAMILY_ARCHS:
                whole, local = res["local_caches"][(arch, 0)], res["local_caches"][(arch, n)]
                assert set(local) == set(whole) and heads & set(whole), arch
                for name, shape in whole.items():
                    split = name in heads and shape[2] % n == 0
                    want = shape[:2] + (shape[2] // n,) + shape[3:] if split else shape
                    assert local[name] == want, (arch, n, name)
        for res in rank_results[n:]:
            assert all((arch, n) not in res["local_caches"] for arch in ranks.FAMILY_ARCHS)


def test_mesh_payload_width_is_the_unsharded_engines(rank_results):
    """Reduced zamba2 (2 Mamba2 layers, one application of the shared
    block): the mesh engine's tier rows span the cache's own first axis
    (the applications, not the layers) and every KV head, as the unsharded
    engine's do, while each rank's cache holds its share of the heads."""
    for n in (1, 2, WORLD):
        for res in rank_results[:n]:
            width, cache = res["payload"][n]
            assert width == res["payload"][0] and cache[0] == 1 and cache[2] == 4 // n


def test_scans_on_local_heads_equal_the_whole_calls_slice(rank_results):
    """B6's and B7's plain versions on this rank's heads (8 heads: 4 a rank
    over 2, 2 over 4) equal the same heads' slice of the whole-head call,
    outputs and final states."""
    for rank, res in enumerate(rank_results):
        for name, (local_heads, out_err, state_err) in res["scans"].items():
            assert local_heads == 8 // WORLD, (name, rank)
            assert out_err == 0.0 and state_err == 0.0, (name, rank, out_err, state_err)


def test_one_rank_mesh_runs_the_plain_paths_products(rank_results):
    """Every family's prefill and decode at bf16 compute on a 1-rank mesh
    run the plain path's summing ops (products, reductions, sorts) on
    the same shapes, strides and dtypes, so the card's 1-card mesh picks
    the same kernels (smoke phase 11 holds it bit-equal to the engine
    without a mesh), and the logits are bit-equal here. A 3-D DTensor
    product left to DTensor's decomposition batches it (``bmm``) where a
    plain one folds (``mm``): ``common.matmul_f32`` folds it."""
    got = rank_results[0]["one_rank_ops"]
    assert set(got) == set(ranks.FAMILY_ARCHS)
    for arch, checks in got.items():
        assert all(checks.values()), (arch, checks)
    assert all("one_rank_ops" not in res for res in rank_results[1:])
