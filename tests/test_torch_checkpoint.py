"""The port's CheckpointManager against the JAX package's, on the CPU.

1. The reference's own manager tests (``tests/test_runtime.py:73-96``),
   on tensors.
2. The on-disk layout is the reference's: a checkpoint the JAX ``Trainer``
   wrote after 2 steps (reduced smollm-360m, whisper-base with its
   ``enc_layers`` and ``dec_layers`` stacks, rwkv6-7b; non-zero m, v and
   step), restored into the port's ``Trainer`` and saved again by the port's
   manager, gives the same file names, the same ``meta.json`` but for
   ``treedef`` (each package describes its own tree) and the same ``.npy``
   bytes. Restores cross bit-exact both ways: the JAX state into the port's
   ``Trainer``, and the port's state after one more step into the JAX
   ``CheckpointManager``.
3. The traps: ``save_async``'s snapshot of CPU tensors is a copy (the train
   step writes the parameters in place while the writer runs), and a
   restore writes in place, so a model's held casts cast anew and its next
   forward gives the restored parameters' logits.
4. Errors: orphans, a writer's error at ``wait``, a template that does not
   fit, and the mesh paths (ROADMAP A11).
"""
import dataclasses
import json
import os
import shutil
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.checkpoint import CheckpointManager as JaxCheckpointManager  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.data.synthetic import SyntheticCorpus as JaxCorpus  # noqa: E402
from repro.data.synthetic import token_batches as jax_token_batches  # noqa: E402
from repro.models.api import get_model as jax_model  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.runtime.trainer import Trainer as JaxTrainer  # noqa: E402
from repro.runtime.trainer import TrainerConfig as JaxTrainerConfig  # noqa: E402

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.synthetic import SyntheticCorpus, token_batches  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.optim.adamw import leaf_order  # noqa: E402
from repro_torch.parity import params_from_jax  # noqa: E402
from repro_torch.runtime.elastic import elastic_restore  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainerConfig  # noqa: E402

LR = 1e-2


# ---------------------------------------------------------------------------
# 1. the reference's manager tests


def test_checkpoint_roundtrip_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"w": torch.arange(12.0).reshape(3, 4), "n": torch.tensor(7, dtype=torch.int32)}
    for step in (1, 2, 3):
        mgr.save(step, state)
    assert mgr.latest_step() == 3
    template = {"w": torch.zeros(3, 4), "n": torch.tensor(0, dtype=torch.int32)}
    restored, extras = mgr.restore(template)
    assert torch.equal(restored["w"], state["w"]) and int(restored["n"]) == 7 and extras == {}
    steps = sorted(int(d.split("_")[-1]) for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == [2, 3]  # keep=2 garbage-collected step 1


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"w": torch.ones((128, 128))}
    mgr.save_async(10, state)
    mgr.wait()
    assert mgr.latest_step() == 10


# ---------------------------------------------------------------------------
# 2. the reference's layout, and restores across the packages


def _batches(cfg, start_step: int = 0):
    """token_batches of 8 sequences of 16 tokens; an audio model's batch
    also holds 8 clips of its frames, normal draws seeded by the step."""
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, seq_len=16)
    for step, batch in token_batches(corpus, 8, start_step=start_step):
        if cfg.family == "audio":
            rng = np.random.default_rng(step)
            batch["frames"] = rng.standard_normal((8, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
        yield step, batch


def _jax_batches(cfg):
    corpus = JaxCorpus(vocab_size=cfg.vocab_size, seq_len=16)
    for (step, batch), (_, port) in zip(jax_token_batches(corpus, 8), _batches(cfg)):
        np.testing.assert_array_equal(batch["tokens"], port["tokens"])  # the copied corpus is the reference's
        yield step, {**port, **batch}


@pytest.fixture(scope="module", params=["smollm-360m", "whisper-base", "rwkv6-7b"])
def jax_run(request, tmp_path_factory):
    """The JAX Trainer after 2 steps of AdamW (checkpoint every 2): its
    checkpoint directory and its final state as numpy trees."""
    arch = request.param
    d = tmp_path_factory.mktemp(arch)
    cfg = jax_config(arch).reduced()
    tr = JaxTrainer(jax_model(cfg), JaxAdamWConfig(lr=LR), JaxTrainerConfig(ckpt_dir=str(d), ckpt_every=2))
    tr.init_state(0)
    tr.run(_jax_batches(cfg), 2)
    return {"arch": arch, "dir": d, "params": jax.tree.map(np.asarray, tr.params),
            "opt_state": jax.tree.map(np.asarray, tr.opt_state), "template": (tr.params, tr.opt_state)}


def _port_trainer(arch, ckpt_dir):
    api = get_model(get_config(arch).reduced())
    return Trainer(api, AdamWConfig(lr=LR), TrainerConfig(ckpt_dir=str(ckpt_dir), ckpt_every=2), device="cpu")


def _assert_state_equal(tr, params, opt_state, step):
    """The port trainer's state equals a reference state (numpy trees), bit for bit."""
    want = params_from_jax(params)
    got = tr.params.state_dict()
    assert sorted(got) == sorted(want)
    for name, t in got.items():
        assert torch.equal(t, want[name]), name
    for k in ("m", "v"):
        want = params_from_jax(opt_state[k])
        assert sorted(tr.opt_state[k]) == sorted(want)
        for name, t in tr.opt_state[k].items():
            assert torch.equal(t, want[name]), (k, name)
    assert tr.opt_state["step"].dtype == torch.int32 and int(tr.opt_state["step"]) == step == tr.step


def test_jax_checkpoint_restores_into_the_port_trainer(jax_run, tmp_path):
    shutil.copytree(jax_run["dir"], tmp_path / "ckpt")
    tr = _port_trainer(jax_run["arch"], tmp_path / "ckpt")
    assert tr.try_restore()
    _assert_state_equal(tr, jax_run["params"], jax_run["opt_state"], 2)
    assert float(np.abs(jax_run["opt_state"]["v"]["embed"]).max()) > 0  # the moments moved


def test_port_checkpoint_writes_the_reference_layout(jax_run, tmp_path):
    """The state the JAX Trainer saved at step 2, restored into the port and
    saved by its manager: the same directory, files and bytes."""
    shutil.copytree(jax_run["dir"], tmp_path / "ckpt")
    tr = _port_trainer(jax_run["arch"], tmp_path / "ckpt")
    assert tr.try_restore()
    CheckpointManager(str(tmp_path / "port")).save(2, (tr.params, tr.opt_state), {"step": 2})
    ref, port = jax_run["dir"] / "step_00000002", tmp_path / "port" / "step_00000002"
    assert sorted(os.listdir(jax_run["dir"])) == sorted(os.listdir(tmp_path / "port")) == ["step_00000002"]
    assert sorted(os.listdir(ref)) == sorted(os.listdir(port))
    metas = [json.loads((d / "meta.json").read_text()) for d in (ref, port)]
    assert list(metas[0]) == list(metas[1])
    assert metas[1]["treedef"].startswith("repro_torch leaves (0.")
    for m in metas:
        m.pop("treedef")
    assert metas[0] == metas[1]
    n_params = len(leaf_order(tr.params.state_dict()))
    assert metas[1]["n_leaves"] == 3 * n_params + 1 and metas[1]["dtypes"][2 * n_params] == "int32"
    for name in sorted(os.listdir(ref)):
        if name.endswith(".npy"):
            assert (ref / name).read_bytes() == (port / name).read_bytes(), name


def test_port_checkpoint_restores_into_the_jax_manager(jax_run, tmp_path):
    """The port's Trainer takes one more step from the JAX state and saves;
    the JAX manager restores that checkpoint into the JAX tree bit for bit."""
    shutil.copytree(jax_run["dir"], tmp_path / "ckpt")
    tr = _port_trainer(jax_run["arch"], tmp_path / "ckpt")
    assert tr.try_restore()
    cfg = tr.api.cfg
    tr.run(_batches(cfg, start_step=2), 1)
    tr.save(sync=True)
    (params, opt_state), extras = JaxCheckpointManager(str(tmp_path / "ckpt")).restore(jax_run["template"])
    assert extras == {"step": 3}
    _assert_state_equal(tr, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, opt_state), 3)


# ---------------------------------------------------------------------------
# 3. the snapshot is a copy; a restore refreshes the held casts


def test_save_async_snapshot_is_not_the_live_tensors(tmp_path):
    """The writer is held until the live CPU tensors (and the model's
    parameters, as the train step does) have been written in place: the
    checkpoint still holds the values at the snapshot."""
    api = get_model(get_config("smollm-360m").reduced())
    model = api.init(0, device="cpu")
    state = {"w": torch.arange(6.0), "model": model}
    before = {n: t.clone() for n, t in model.state_dict().items()}
    mgr = CheckpointManager(str(tmp_path))
    release, write = threading.Event(), mgr._write

    def held_write(*args):
        assert release.wait(timeout=30)
        write(*args)

    mgr._write = held_write
    mgr.save_async(1, state)
    with torch.no_grad():
        state["w"].add_(100.0)
        for p in model.parameters():
            p.add_(1.0)
    release.set()
    mgr.wait()
    template = {"w": torch.zeros(6), "model": api.init(1, device="cpu")}
    restored, _ = mgr.restore(template)
    assert torch.equal(restored["w"], torch.arange(6.0))
    for name, t in restored["model"].state_dict().items():
        assert torch.equal(t, before[name]), name


def test_restore_in_place_refreshes_the_held_casts(tmp_path):
    """A model that served (its bf16 casts held) and is then restored from
    another model's checkpoint gives that model's logits, bit for bit."""
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(), compute_dtype="bfloat16")
    api = get_model(cfg)
    src, dst = api.init(0, device="cpu"), api.init(1, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32))
    with torch.no_grad():
        want, _ = api.prefill(src, {"tokens": tokens}, max_len=16)
        stale, _ = api.prefill(dst, {"tokens": tokens}, max_len=16)
    assert dst.layers[0].attn.__dict__.get("_casts")  # the casts are held
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, src)
    params = list(dst.parameters())
    restored, _ = mgr.restore(dst)
    assert restored is dst and all(a is b for a, b in zip(params, dst.parameters()))  # in place
    with torch.no_grad():
        got, _ = api.prefill(dst, {"tokens": tokens}, max_len=16)
    assert not torch.equal(stale, want) and torch.equal(got, want)


# ---------------------------------------------------------------------------
# 4. errors


def test_gc_orphans_removes_a_partial_checkpoint(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones(3)})
    os.makedirs(tmp_path / "step_00000002.tmp")
    (tmp_path / "step_00000002.tmp" / "arr_00000.npy").write_bytes(b"partial")
    assert mgr.latest_step() == 1
    CheckpointManager(str(tmp_path))  # a restarted process cleans up
    assert sorted(os.listdir(tmp_path)) == ["step_00000001"]


def test_writer_error_reraises_at_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    (tmp_path / "step_00000005.tmp").write_text("a file where the writer makes its directory")
    mgr.save_async(5, {"w": torch.ones(3)})
    with pytest.raises(FileExistsError):
        mgr.wait()
    mgr.wait()  # raised once
    assert mgr.latest_step() is None


def test_restore_refuses_what_does_not_fit(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore({"w": torch.zeros(3)})
    mgr.save(1, {"w": torch.ones(3), "n": torch.tensor(2, dtype=torch.int32)})
    with pytest.raises(ValueError, match="leaf mismatch"):
        mgr.restore({"w": torch.zeros(3)})
    with pytest.raises(ValueError, match="does not fit"):
        mgr.restore({"w": torch.zeros(4), "n": torch.tensor(0, dtype=torch.int32)})
    with pytest.raises(ValueError, match="does not fit"):
        mgr.restore({"w": torch.zeros(3), "n": torch.tensor(0.0)})
    with pytest.raises(TypeError, match="not a tensor"):
        mgr.save(2, {"w": np.ones(3)})


def test_mesh_restores_name_their_roadmap_item(tmp_path):
    """Restoring onto a mesh (ROADMAP A11.3, ported): a checkpoint saved
    from one device restores onto a 1-rank mesh through ``elastic_restore
    (mesh, specs)``, every leaf a DTensor placed at its spec and equal to
    what was saved; ``restore(shardings=)`` refuses a template not placed
    as its shardings say; with no mesh the restore is the plain one."""
    import _torch_mesh_ranks as ranks
    from repro_torch.launch import mesh as meshlib
    from repro_torch.runtime.elastic import shardings_for

    mgr = CheckpointManager(str(tmp_path))
    w = torch.arange(12.0).reshape(3, 4)
    mgr.save(3, {"w": w, "n": torch.tensor(5, dtype=torch.int32)}, {"step": 3})
    specs = {"w": (None, "model"), "n": ()}
    with ranks.one_rank_mesh(str(tmp_path / "store"), shape=(1,), names=("model",)) as mesh:
        state, extras = elastic_restore(mgr, {"w": torch.zeros(3, 4), "n": torch.tensor(0, dtype=torch.int32)},
                                        mesh, specs)
        assert extras == {"step": 3} and meshlib.is_dtensor(state["w"]) and int(state["n"]) == 5
        assert torch.equal(state["w"].full_tensor(), w)
        with pytest.raises(ValueError, match="place the template"):
            mgr.restore({"w": torch.zeros(3, 4), "n": torch.tensor(0, dtype=torch.int32)},
                        shardings=shardings_for(mesh, specs))
    state, extras = elastic_restore(mgr, {"w": torch.zeros(3, 4), "n": torch.tensor(0, dtype=torch.int32)})
    assert torch.equal(state["w"], w) and extras == {"step": 3}
