"""The port's train step across a mesh of ranks (weight pooling: ZeRO storage
over the ``pool`` axis) against the reference's jitted step on 4 host
devices, on the CPU.

The reference's three pooled configs, reduced: qwen1.5-110b (dense, with
its ``sp_activations``: B5 at each rank's first query row) 8 x 32 tokens
over (data, pool, model) = (1, 2, 2), (1, 4, 1), (2, 1, 2) and (1, 1, 4);
rwkv6-7b (ssm, ``grad_accum`` 8: B6 on each rank's heads) 16 x 32 over (1,
2, 2) and (2, 1, 2); qwen2-moe-a2.7b (moe, ``grad_accum`` 4, TP-for-MoE)
8 x 32 over (1, 2, 2). Each: two steps of ``make_train_step`` from the same
parameters (the reference's seed-1 init) and one numpy-seeded batch, the
parameters and AdamW's moments placed at ``core.pooling.pooled_specs``
(``launch.mesh.place_params``), against ``tests/_jax_mesh_train.py`` (the
reference's step jitted with ``launch/dryrun.py``'s placements, one
subprocess for the module). Held: every metric, on every rank the same,
within the tolerances ``tests/test_torch_train_step.py`` holds each family
to (1e-5; a recurrent model's second step 1e-4); the parameters and both
moments within ``TOL`` (below); each rank's local shard shapes equal to the
reference's shard shapes, the moments placed as their parameters; and
``pooled_specs`` of the three configs at full size over the four mesh
shapes equal to the reference's, leaf for leaf.

Restores across meshes: the first case's state, saved from (1, 2, 2) (one
rank writes), restores onto (1, 4, 1) and onto one plain device, its full
tensors bit-equal to what was saved; the step after the restore is
bit-equal to a step from the same state placed directly; the files are
the reference manager's layout byte for byte, and the reference's
``restore(shardings=)`` reads them. Serving: the mesh engine over 2 ranks
with ``sp_activations`` on (reduced qwen1.5-110b, prefills split over the
sequence) gives the reference N-device engine's tokens and books
bit-exact and its prefill logits within 1e-4 of their scale.

One spawn of 4 ``gloo`` ranks (``tests/_torch_mesh_ranks.py``, one
intra-op thread a rank) runs beside the reference's subprocess. The ranks
run each step's backward on a thread of its own, as autograd runs a CUDA
backward on its device thread (a remat recompute there once lost the
active mesh on the cards); ``pooling.gather`` places the first case's
model at its compute layout, leaf by leaf.

``TOL``: the parameters take the rule ``tests/test_torch_trainer.py``
holds the port's Trainer to against the reference's: every element within
lr / 10 (plus 2e-4 relative), and at most 1e-3 of a leaf's elements beyond
lr / 100 (rwkv6: lr / 10 for every element, ``tests/test_torch_train_step.py``'s
recurrent tolerance: its scan carries each rounding into every later
gradient). An element whose gradient is a few eps moves by about lr in
AdamW's first steps whatever its size, so f32 ordering decides it (one of
8,192 of qwen's ``wo`` moved 2.3e-4, one of 32,768 of qwen2-moe's
embedding 2.6e-4). The attention key bias (``bk``, qwen's QKV bias) has an
exactly zero gradient (a bias on every key moves each query's scores
alike, which the softmax ignores), so every element of it is such an
element, and it is held to lr / 10 alone (3.3e-4 seen). m is a running
mean of clipped gradients and v of their squares; both sides sum the
gradients in other orders (~1e-7 of their scale), and the second step's
gradients meet parameters that already differ by the above, so each
moment is held to 5e-4 of its leaf's largest magnitude (plus 1e-7 absolute
for v, whose entries start at zero; 2.1e-4 seen on qwen's ``lm_head``),
2e-3 for rwkv6 and qwen2-moe (9.6e-4 relative on four of rwkv6's
embedding elements seen).
"""
import json
import os
import pickle
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import _torch_mesh_ranks as ranks  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402
from repro.checkpoint import CheckpointManager as JaxCheckpointManager  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models.api import get_model as jax_model  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import pooling  # noqa: E402
from repro_torch.launch import mesh as meshlib  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.optim.adamw import LAYER_STACK  # noqa: E402
from repro_torch.parity import assert_close, tree_from_state  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
LR = 1e-2
OPT = {"lr": LR, "clip_norm": 0.5}
RECURRENT_METRICS = 1e-4
# (share bound, moments) a family; every element within lr / 10 (module docstring)
TOL = {"dense": {"params": LR / 100, "moments": 5e-4}, "ssm": {"params": LR / 10, "moments": 2e-3},
       "moe": {"params": LR / 100, "moments": 2e-3}}
ZERO_GRADIENT = "layers.attn.bk"  # its gradient is rounding alone (module docstring)
LOGIT_TOL = 1e-4
CASES = [("qwen1.5-110b", shape, 8, 32) for shape in ((1, 2, 2), (1, 4, 1), (2, 1, 2), (1, 1, 4))] + \
        [("rwkv6-7b", shape, 16, 32) for shape in ((1, 2, 2), (2, 1, 2))] + \
        [("qwen2-moe-a2.7b", (1, 2, 2), 8, 32)]
IDS = ["{}-{}".format(arch, "x".join(map(str, shape))) for arch, shape, _, _ in CASES]
ENGINE = ("qwen1.5-110b:sp", 2)
ENGINE_CASE = (ENGINE[0], ENGINE[1], 0)


def _flat(tree, prefix=""):
    for k, v in sorted(tree.items()):
        yield from _flat(v, f"{prefix}{k}.") if isinstance(v, dict) else [(prefix + k, v)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train")
    trees, batches = {}, {}
    for arch, _, b, s in CASES:
        cfg = jax_config(arch).reduced()
        trees[arch] = jax.tree.map(np.asarray, jax_model(cfg).init(jax.random.PRNGKey(1)))
        rng = np.random.default_rng(0)
        batches[arch] = tuple(rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32) for _ in range(2))
    inp = {"cases": CASES, "trees": trees, "batches": batches, "opt": OPT, "engine": ENGINE}
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    ref_proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "_jax_mesh_train.py"), str(tmp / "in.pkl"),
                                 str(tmp / "out.pkl")], env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    try:
        port = ranks.spawn(ranks.train_run, WORLD, str(tmp / "store"), inp, str(tmp / "ckpt"), timeout=600.0)
        log = ref_proc.communicate(timeout=600)[0]
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
    assert ref_proc.returncode == 0, log[-4000:]
    with open(tmp / "out.pkl", "rb") as f:
        ref = pickle.load(f)
    return {"port": port, "ref": ref, "ckpt": tmp / "ckpt", "trees": trees}


# ---------------------------------------------------------------------------
# the train step


@pytest.mark.parametrize("arch,shape", [c[:2] for c in CASES], ids=IDS)
def test_train_step_matches_the_reference(runs, arch, shape):
    ref = runs["ref"]["train"][(arch, shape)]
    port = [r["train"][(arch, shape)] for r in runs["port"]]
    family = get_config(arch).family
    for i, want in enumerate(ref["metrics"]):
        got = port[0]["metrics"][i]
        assert sorted(got) == sorted(want)
        tol = RECURRENT_METRICS if family == "ssm" and i > 0 else 1e-5
        for k, w in want.items():
            assert_close(np.float32(got[k]), np.float32(w), atol=tol, rtol=tol, what=f"step {i} {k}")
        assert all(r["metrics"][i] == got for r in port)  # the same on every rank
    assert port[0]["metrics"][1]["loss"] < port[0]["metrics"][0]["loss"]
    whole = port[0]["whole"]
    tol = TOL[family]
    got = dict(_flat(tree_from_state({n: torch.from_numpy(a) for n, a in whole["params"].items()})))
    for name, want in _flat(ref["params"]):
        assert_close(got[name], want, atol=LR / 10, rtol=2e-4, what=name)
        beyond = np.abs(np.asarray(got[name]) - want) > tol["params"] + 2e-4 * np.abs(want)
        assert name == ZERO_GRADIENT or float(beyond.mean()) <= 1e-3, (name, int(beyond.sum()))
    for k in ("m", "v"):
        got = dict(_flat(tree_from_state({n: torch.from_numpy(a) for n, a in whole[k].items()})))
        for name, want in _flat(ref[k]):
            scale = float(np.abs(want).max())
            assert_close(got[name], want, atol=tol["moments"] * scale + (1e-7 if k == "v" else 0.0), rtol=0,
                         what=f"{k} {name}")


@pytest.mark.parametrize("arch,shape", [c[:2] for c in CASES], ids=IDS)
def test_local_shards_are_the_reference_shards(runs, arch, shape):
    """Each rank's local shape of every leaf is the reference's shard shape
    (a stacked leaf's less its layer axis; a stack the specs pool along
    its layer axis is held whole over it, one module a layer), and the
    moments are placed as their parameters."""
    ref = runs["ref"]["train"][(arch, shape)]
    flat_specs = dict(_flat(ref["specs"]))
    whole_layer = {path for path, spec in flat_specs.items()  # stacks the specs pool along L
                   if LAYER_STACK.match(path.split(".")[0] + ".0.") and spec and spec[0] is not None}
    flat = {}  # the shard shapes (tuples) by reference path

    def walk(tree, prefix=""):
        for k, v in tree.items():
            walk(v, f"{prefix}{k}.") if isinstance(v, dict) else flat.__setitem__(prefix + k, v)

    walk(ref["shards"])
    full = {n: tuple(a.shape) for n, a in runs["port"][0]["train"][(arch, shape)]["whole"]["params"].items()}
    for rank in range(WORLD):
        got = runs["port"][rank]["train"][(arch, shape)]
        for name, local in got["shapes"].items():
            m = LAYER_STACK.match(name)
            path = f"{m.group(1)}.{name[m.end():]}" if m else name
            want = flat[path]
            if m:
                n_layers = sum(1 for n in full if LAYER_STACK.match(n) and n[m.end():] == name[m.end():])
                assert path in whole_layer or want[0] == n_layers, name
                want = want[1:]
            assert local == want, (rank, name, local, want)
            assert got["moments"][name] == (local, local), name


@pytest.mark.parametrize("arch", ["qwen1.5-110b", "rwkv6-7b", "qwen2-moe-a2.7b"])
def test_pooled_specs_at_full_size_equal_the_reference(runs, arch):
    api = get_model(get_config(arch))
    meta = api.abstract_params()
    for (a, shape), want in runs["ref"]["specs"].items():
        if a != arch:
            continue
        mesh = types.SimpleNamespace(mesh_dim_names=ranks.MESH_AXES, shape=shape)
        got = pooling.pooled_specs(api.param_specs(), meta, mesh)
        assert dict(_flat(got)) == {k: tuple(v) for k, v in _flat(want)}, shape
        assert any(meshlib.POOL in s for _, s in _flat(got))


def test_gather_places_each_leaf_at_its_compute_layout(runs):
    """``pooling.gather`` of the first case's pooled model: every leaf at its
    compute spec's placement, one at a time, with the stored values."""
    assert all(r["gather"] for r in runs["port"])


# ---------------------------------------------------------------------------
# restores across meshes


def _assert_equal(a: dict, b: dict):
    for k in ("params", "m", "v"):
        assert sorted(a[k]) == sorted(b[k])
        for n in a[k]:
            np.testing.assert_array_equal(a[k][n], b[k][n], err_msg=f"{k} {n}")


def test_restore_onto_another_mesh_and_one_device_is_bit_equal(runs):
    r = runs["port"][0]["restore"]
    assert r["extras"] == {"step": 2} and r["step"] == r["plain_step"] == 2
    _assert_equal(r["restored"], r["saved"])
    _assert_equal(r["plain"], r["saved"])
    api = get_model(get_config(CASES[0][0]).reduced())
    specs = pooling.pooled_specs(api.param_specs(), api.abstract_params(),
                                 types.SimpleNamespace(mesh_dim_names=ranks.MESH_AXES, shape=(1, 4, 1)))
    for rank in range(WORLD):  # each rank holds its (1, 4, 1) slices
        for name, local in runs["port"][rank]["restore"]["shapes"].items():
            spec = meshlib.leaf_spec(specs, name)
            full = r["saved"]["params"][name].shape
            assert local == tuple(n // 4 if a == meshlib.POOL else n for n, a in zip(full, spec)), name


def test_step_after_restore_equals_a_step_from_the_placed_state(runs):
    for rank in range(WORLD):
        restored, direct = runs["port"][rank]["restore"]["next"]
        assert restored == direct
    after, direct = runs["port"][0]["restore"]["after"]
    _assert_equal(after, direct)


def test_checkpoint_files_are_the_reference_layout(runs, tmp_path):
    """The files the ranks wrote are the reference manager's for the same
    state, byte for byte (``meta.json`` but its tree description), and the
    reference's ``restore(shardings=)`` reads them."""
    r = runs["port"][0]["restore"]["saved"]
    tree = lambda d: tree_from_state({n: torch.from_numpy(a) for n, a in d.items()})
    state = (tree(r["params"]), {"m": tree(r["m"]), "v": tree(r["v"]), "step": np.int32(2)})
    JaxCheckpointManager(str(tmp_path)).save(2, state, {"step": 2})
    ref, port = tmp_path / "step_00000002", runs["ckpt"] / "step_00000002"
    assert sorted(os.listdir(ref)) == sorted(os.listdir(port))
    metas = [json.loads((d / "meta.json").read_text()) for d in (ref, port)]
    for m in metas:
        m.pop("treedef")
    assert metas[0] == metas[1]
    for name in sorted(os.listdir(ref)):
        if name.endswith(".npy"):
            assert (ref / name).read_bytes() == (port / name).read_bytes(), name
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1, 1), ranks.MESH_AXES)
    template = jax.tree.map(jax.numpy.asarray, state)
    shardings = jax.tree.map(lambda _: NamedSharding(mesh, P()), template)
    (params, opt), extras = JaxCheckpointManager(str(runs["ckpt"])).restore(template, shardings=shardings)
    assert extras == {"step": 2}
    for (name, want), (_, got) in zip(_flat(state[0]), _flat(jax.tree.map(np.asarray, params))):
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=name)
    assert all(x.sharding == NamedSharding(mesh, P()) for x in jax.tree.leaves(params))


# ---------------------------------------------------------------------------
# serving with sp_activations


def test_sp_engine_tokens_and_books_equal_the_reference(runs):
    port = [r["engine"] for r in runs["port"]]
    ref = {ENGINE_CASE: runs["ref"]["engine"]}
    ranks.check_tokens_and_books(port, ref, ENGINE_CASE, WORLD)
    ranks.check_prefill_logits(port, ref, ENGINE_CASE, LOGIT_TOL)
    cfg = get_config("qwen1.5-110b").reduced()
    assert cfg.sp_activations
    for rank in range(ENGINE[1]):  # sp: every rank's cache holds every KV head
        assert port[rank][ENGINE_CASE]["cache"]["k"][2] == cfg.n_kv_heads
