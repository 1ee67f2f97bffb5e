"""The port's Trainer, data loader and train launcher, on the CPU.

1. The reference's trainer and data tests (``tests/test_runtime.py:41-170``),
   its two slow ones cheap and unmarked here: reduced smollm-360m, 8
   sequences of 16 tokens a step; the crash-resume run is bit-equal
   (``torch.equal``) to a clean one on every parameter and AdamW leaf.
2. The port's Trainer follows the JAX Trainer: both start from the JAX
   Trainer's step-0 checkpoint and take 3 steps over ``token_batches``,
   metrics within 1e-5 and all but 1e-3 of the parameters within
   ``tests/test_torch_train_step.py``'s PARAM_ATOL (lr / 100 plus 2e-4
   relative), every one within lr / 10: both are f32 and sum in other
   orders, and AdamW divides each gradient by its own RMS, so an element
   whose gradient is a few eps moves by a share of lr its rounding decides.
3. The launcher (``python -m repro_torch.launch.train``) starts fresh,
   resumes from its last checkpoint and raises at ``--fail-at``; without
   ``--device`` it wants the card, as the Trainer does.
"""
import dataclasses
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.data.synthetic import SyntheticCorpus as JaxCorpus  # noqa: E402
from repro.data.synthetic import token_batches as jax_token_batches  # noqa: E402
from repro.models.api import get_model as jax_model  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.runtime.trainer import Trainer as JaxTrainer  # noqa: E402
from repro.runtime.trainer import TrainerConfig as JaxTrainerConfig  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.loader import ShardedLoader  # noqa: E402
from repro_torch.data.synthetic import SyntheticCorpus, token_batches  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.parity import assert_close, params_from_jax  # noqa: E402
from repro_torch.runtime import StragglerMonitor, Trainer, TrainerConfig  # noqa: E402
from repro_torch.runtime.trainer import SimulatedFailure  # noqa: E402

ARCH = "smollm-360m"
LR = 1e-2
PARAM_ATOL = LR / 100  # tests/test_torch_train_step.py's


def _mk_trainer(tmp, arch=ARCH, lr=1e-3, **tkw):
    cfg = get_config(arch).reduced()
    api = get_model(cfg)
    tr = Trainer(api, AdamWConfig(lr=lr), TrainerConfig(ckpt_dir=str(tmp), ckpt_every=3, **tkw), device="cpu")
    return cfg, api, tr


def _state(tr) -> dict:
    """Every parameter and AdamW leaf of a trainer, by name."""
    out = {f"params.{n}": t for n, t in tr.params.state_dict().items()}
    for k in ("m", "v"):
        out.update({f"{k}.{n}": t for n, t in tr.opt_state[k].items()})
    out["step"] = tr.opt_state["step"]
    return out


# ---------------------------------------------------------------------------
# 1. the reference's trainer and data tests


def test_loss_decreases(tmp_path):
    cfg, api, tr = _mk_trainer(tmp_path)
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, seq_len=16)
    tr.init_state()
    log = tr.run(token_batches(corpus, 8), 20)
    first = np.mean([m["loss"] for m in log[:4]])
    last = np.mean([m["loss"] for m in log[-4:]])
    assert last < first, (first, last)


def test_crash_resume_bitwise(tmp_path):
    """Crash at step 5, restart -> identical params and AdamW state at step 9 as a clean run."""
    cfg, api, tr = _mk_trainer(tmp_path / "a")
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, seq_len=16)
    tr.init_state()
    with pytest.raises(SimulatedFailure):
        tr.run(token_batches(corpus, 8), 9, fail_at=5)
    tr.ckpt.wait()
    # restart from disk
    cfg2, api2, tr2 = _mk_trainer(tmp_path / "a")
    assert tr2.try_restore()
    assert tr2.step == 3  # last checkpoint (ckpt_every=3)
    tr2.run(token_batches(corpus, 8, start_step=tr2.step), 9 - tr2.step)
    # clean run, no crash
    cfg3, api3, tr3 = _mk_trainer(tmp_path / "b")
    tr3.init_state()
    tr3.run(token_batches(corpus, 8), 9)
    a, b = _state(tr2), _state(tr3)
    assert sorted(a) == sorted(b) and int(a["step"]) == 9
    for name in a:
        assert torch.equal(a[name], b[name]), name
    assert [m["loss"] for m in tr2.metrics_log] == [m["loss"] for m in tr3.metrics_log[3:]]


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(z=3.0, min_steps=4)
    for i in range(20):
        mon.observe(i, 0.1 + 0.001 * (i % 3))
    assert not mon.flagged
    assert mon.observe(20, 2.0)  # 20x step time -> straggler
    assert mon.flagged and mon.flagged[-1][0] == 20


def test_loader_determinism_and_restore():
    corpus = SyntheticCorpus(vocab_size=128, seq_len=8)
    l1 = ShardedLoader(corpus, global_batch=4, host_id=0, n_hosts=1)
    batches = [next(l1) for _ in range(6)]
    state = l1.state()
    nxt = next(l1)
    l1.close()
    l2 = ShardedLoader.restore(corpus, 4, state, host_id=0, n_hosts=1)
    nxt2 = next(l2)
    l2.close()
    assert [s for s, _ in batches] == list(range(6)) and nxt[0] == nxt2[0] == 6
    np.testing.assert_array_equal(nxt[1]["tokens"], nxt2[1]["tokens"])


def test_loader_host_sharding_disjoint():
    corpus = SyntheticCorpus(vocab_size=128, seq_len=8)
    l0 = ShardedLoader(corpus, global_batch=8, host_id=0, n_hosts=2)
    l1 = ShardedLoader(corpus, global_batch=8, host_id=1, n_hosts=2)
    _, b0 = next(l0)
    _, b1 = next(l1)
    l0.close()
    l1.close()
    assert b0["tokens"].shape == (4, 8)  # half the global batch each
    assert not np.array_equal(b0["tokens"], b1["tokens"])


# ---------------------------------------------------------------------------
# 2. the port's Trainer against the JAX Trainer


@pytest.fixture(scope="module")
def jax_trainer(tmp_path_factory):
    """The JAX Trainer's step-0 checkpoint (seed-1 weights) in its own
    directory, then its 3 steps over token_batches: metrics and the params
    after each step (copied: the next step donates their buffers)."""
    d = tmp_path_factory.mktemp("jax")
    cfg = jax_config(ARCH).reduced()
    tr = JaxTrainer(jax_model(cfg), JaxAdamWConfig(lr=LR, clip_norm=0.5), JaxTrainerConfig(ckpt_dir=str(d / "run")))
    tr.init_state(1)
    tr.save(sync=True)
    shutil.copytree(d / "run", d / "start")
    params = []
    log = tr.run(jax_token_batches(JaxCorpus(vocab_size=cfg.vocab_size, seq_len=16), 8), 3,
                 on_step=lambda step, m: params.append(jax.tree.map(lambda x: np.array(x, copy=True), tr.params)))
    return {"start": d / "start", "log": log, "params": [params_from_jax(p) for p in params]}


def test_trainer_follows_the_jax_trainer(jax_trainer, tmp_path):
    """Metrics to 1e-5 at every step. Parameters after each step: all but
    1e-3 of each leaf's elements within PARAM_ATOL (plus 2e-4 relative),
    and every element within lr / 10. AdamW moves an element by
    lr * m_hat / (sqrt(v_hat) + eps), which for a gradient within a few eps
    of zero is a share of lr that the gradient's f32 rounding decides: on
    this corpus one ``w_up`` element has gradient 2.10e-9 in JAX and
    2.42e-9 here (3e-10 apart, 2e-7 of the leaf's largest gradient), so
    its first update is 0.173 lr against 0.195 lr, 2.1e-4 apart (2 such
    elements of 8,192 in the leaf); lr / 10 leaves that gap five times."""
    shutil.copytree(jax_trainer["start"], tmp_path / "ckpt")
    cfg = get_config(ARCH).reduced()
    tr = Trainer(get_model(cfg), AdamWConfig(lr=LR, clip_norm=0.5), TrainerConfig(ckpt_dir=str(tmp_path / "ckpt")),
                 device="cpu")
    assert tr.try_restore() and tr.step == 0
    start = {n: t.clone() for n, t in tr.params.state_dict().items()}
    params = []
    log = tr.run(token_batches(SyntheticCorpus(vocab_size=cfg.vocab_size, seq_len=16), 8), 3,
                 on_step=lambda step, m: params.append({n: t.clone() for n, t in tr.params.state_dict().items()}))
    assert len(log) == len(jax_trainer["log"]) == 3
    for i, (got, want) in enumerate(zip(log, jax_trainer["log"])):
        assert sorted(got) == sorted(want) and got["step"] == want["step"] == i + 1
        for k in ("loss", "zloss", "accuracy", "grad_norm", "lr"):
            assert_close(got[k], want[k], atol=1e-5, rtol=1e-5, what=f"step {i + 1} {k}")
    for i, (got, want) in enumerate(zip(params, jax_trainer["params"])):
        for name, t in got.items():
            assert_close(t, want[name], atol=LR / 10, rtol=2e-4, what=f"step {i + 1} {name}")
            beyond = (t - want[name]).abs() > PARAM_ATOL + 2e-4 * want[name].abs()
            assert float(beyond.float().mean()) <= 1e-3, (i + 1, name, int(beyond.sum()))
    moved = max(float((jax_trainer["params"][-1][n] - t).abs().max()) for n, t in start.items())
    assert moved > 100 * PARAM_ATOL  # the steps moved the parameters by far more than the tolerance


def _family_batches(cfg, b: int, s: int, n: int):
    """(step, host batch) pairs of the family's inputs, from a numpy seed:
    labels and tokens, with audio frames for whisper, and embeds and (3, B,
    S) M-RoPE positions in place of tokens for vlm."""
    for step in range(n):
        rng = np.random.default_rng(step)
        batch = {"labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
        if cfg.family == "vlm":
            batch["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
            batch["mrope_positions"] = (np.arange(s)[None, None, :] + rng.integers(0, 4, (3, b, 1))).astype(np.int32)
        else:
            batch["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
        if cfg.family == "audio":
            batch["frames"] = rng.standard_normal((b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
        yield step, batch


def test_trainer_refuses_sharding_specs(tmp_path):
    """``Trainer(compute_specs=)`` trains every family across a mesh: on a
    1-rank mesh, reduced qwen2-vl-7b, zamba2-1.2b and whisper-base (one
    micro-batch a step) each take two steps bit-equal to a Trainer with no
    mesh, and the step-2
    checkpoint restores into a placed template bit for bit. For reduced
    smollm-360m a crash at step 3 resumed from its checkpoint (restored
    into the placed template, in place) ends at step 5 with the state of a
    clean run, bit for bit."""
    import _torch_mesh_ranks as ranks
    from repro_torch.core import pooling
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models.api import trainable
    from repro_torch.optim import adamw_init

    with ranks.one_rank_mesh(str(tmp_path / "families")) as mesh:
        for arch in ("qwen2-vl-7b", "zamba2-1.2b", "whisper-base"):
            api = get_model(dataclasses.replace(get_config(arch).reduced(), grad_accum=1))
            specs = pooling.pooled_specs(api.param_specs(), api.abstract_params(), mesh)
            plain = Trainer(api, AdamWConfig(lr=LR), TrainerConfig(ckpt_dir=str(tmp_path / arch / "plain")),
                            device="cpu")
            plain.init_state()
            plain.run(_family_batches(api.cfg, 4, 8, 2), 2)

            def placed(name):
                tr = Trainer(api, AdamWConfig(lr=LR), TrainerConfig(ckpt_dir=str(tmp_path / arch / name),
                                                                      ckpt_every=2),
                             compute_specs=api.param_specs(), device="cpu")
                tr.params = meshlib.place_params(api.init(0, device="cpu"), mesh, specs)
                tr.opt_state = adamw_init(trainable(tr.params))
                return tr

            tr = placed("mesh")
            tr.run(_family_batches(api.cfg, 4, 8, 2), 2)
            assert [m["loss"] for m in tr.metrics_log] == [m["loss"] for m in plain.metrics_log], arch
            want = _state(plain)
            for name, t in _state(tr).items():
                assert meshlib.is_dtensor(t) == (name != "step"), (arch, name)
                assert torch.equal(meshlib.local(t), want[name]), (arch, name)
            back = placed("mesh")
            assert back.try_restore() and back.step == 2
            for name, t in _state(back).items():
                assert torch.equal(meshlib.local(t), want[name]), (arch, name)
    cfg = get_config(ARCH).reduced()
    api = get_model(cfg)
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, seq_len=16)
    with ranks.one_rank_mesh(str(tmp_path / "store")) as mesh:
        specs = pooling.pooled_specs(api.param_specs(), api.abstract_params(), mesh)

        def trainer(name):
            tr = Trainer(api, AdamWConfig(lr=LR), TrainerConfig(ckpt_dir=str(tmp_path / name), ckpt_every=3),
                         compute_specs=api.param_specs(), device="cpu")
            tr.params = meshlib.place_params(api.init(0, device="cpu"), mesh, specs)
            tr.opt_state = adamw_init(trainable(tr.params))
            return tr

        clean = trainer("clean")
        clean.run(token_batches(corpus, 8), 5)
        crashed = trainer("crash")
        with pytest.raises(SimulatedFailure):
            crashed.run(token_batches(corpus, 8), 5, fail_at=3)
        crashed.ckpt.wait()  # the step-3 checkpoint's background write
        resumed = trainer("crash")
        assert resumed.try_restore() and resumed.step == 3
        resumed.run(token_batches(corpus, 8, start_step=3), 2)
        assert resumed.step == clean.step == 5
        want = _state(clean)
        for name, t in _state(resumed).items():
            assert meshlib.is_dtensor(t) == (name != "step"), name
            assert torch.equal(meshlib.local(t), meshlib.local(want[name])), name


# ---------------------------------------------------------------------------
# 3. the launcher


def _launch(ckpt_dir, *extra):
    return launch_train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--global-batch", "8",
                              "--seq-len", "16", "--ckpt-every", "2", "--log-every", "1",
                              "--ckpt-dir", str(ckpt_dir), *extra])


def test_launcher_starts_resumes_and_fails_on_request(tmp_path, capsys):
    assert _launch(tmp_path, "--steps", "4") == 0
    out = capsys.readouterr().out
    assert "[train] fresh start: smollm-360m" in out and "step     4 loss" in out
    assert "[train] done: step 4" in out
    assert _launch(tmp_path, "--steps", "6") == 0
    out = capsys.readouterr().out
    assert "[train] resumed from step 4" in out and "step     5 loss" in out and "[train] done: step 6" in out
    with pytest.raises(SimulatedFailure, match="after step 7"):
        _launch(tmp_path, "--steps", "10", "--fail-at", "1")
    assert "[train] resumed from step 6" in capsys.readouterr().out
    assert _launch(tmp_path, "--steps", "7") == 0  # the crash left step 6 the newest checkpoint
    assert "[train] resumed from step 6" in capsys.readouterr().out


def test_trainer_and_launcher_without_device_want_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: device=None resolves to it")
    api = get_model(get_config(ARCH).reduced())
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(api, AdamWConfig(), TrainerConfig(ckpt_dir=str(tmp_path / "a")))
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--reduced", "--steps", "1", "--ckpt-dir", str(tmp_path / "b")])
