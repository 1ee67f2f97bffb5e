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
