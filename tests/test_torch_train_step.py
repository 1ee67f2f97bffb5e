"""The port's optimizer and train step against the JAX package's, on the CPU.

1. AdamW: ``test_adamw_reference_step``'s hand-computed numbers, then one
   update of a random tree against ``repro.optim.adamw_update`` (the tree
   keyed by the port's names, a layer stack split onto ``layers.<i>``),
   with clipping and weight decay on, to 1e-6; ``global_norm`` sums the
   reference's leaves in its order; ``warmup_cosine`` to 1e-7.
2. Int8 compression: codes and scales bit-exact against the reference's,
   the round trip within 1/127, and error feedback converging (the
   reference's ``tests/test_runtime.py:110-141``).
3. ``make_train_step``: two steps of tiny smollm-360m, rwkv6-7b,
   zamba2-1.2b and whisper-base (its batch with audio frames, split on
   axis 0 with the tokens) with ``grad_accum=2`` against the reference's
   jitted step: metrics to 1e-5,
   parameters to ``PARAM_ATOL`` = lr / 100 (plus 2e-4 relative). Both
   sides are f32 and sum in other orders, so gradients differ by ~1e-7
   absolute; AdamW then divides each by its own RMS plus eps = 1e-8, and
   where a gradient is itself a few eps (the tied embedding's rows of
   tokens the batch never holds reach 3e-8), a 1e-3 relative difference in
   it moves the update by some 1e-3 of lr: 3e-5 is the largest seen. It
   stands in for the reference's slow
   ``test_grad_accum_matches_single_batch``: ``grad_accum=2`` equals one
   batch of the same rows to the same tolerance. The recurrent families
   (rwkv6, zamba2) carry each step's f32 rounding through the scan into
   every later gradient, and AdamW's first update moves every element by
   about lr whatever its gradient's size, so the second step's gradients
   meet parameters that already differ by those roundings: their second
   step is held to 1e-4 relative on the metrics and lr / 10 on the
   parameters (``RECURRENT_TOL``). rwkv6's squared-ReLU channel mix adds
   gradients that vanish at the kink, whose sign a rounding decides. The
   misses are the ordering's, not the chunked VJP's: autograd through the
   port's sequential plain scans misses the reference as much (grad_norm
   4.3e-5 relative against the VJP's 3.7e-5 on rwkv6; a zamba2 parameter
   1.35e-4 against 1.03e-4; one rwkv6 element of 16,384 in a leaf 5.2e-4,
   the largest seen).
4. The kernels' plain versions stay differentiable on the CPU (the card's
   wrappers raise under grad instead: ``tests/test_torch_cuda.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models.api import get_model as jax_model  # noqa: E402
from repro.models.api import make_train_step as jax_train_step  # noqa: E402
from repro.optim import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jax_adamw_init  # noqa: E402
from repro.optim import adamw_update as jax_adamw_update  # noqa: E402
from repro.optim import compression as jax_compression  # noqa: E402
from repro.optim.adamw import global_norm as jax_global_norm  # noqa: E402
from repro.optim.schedule import warmup_cosine as jax_warmup_cosine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.api import get_model, make_train_step, trainable  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, warmup_cosine  # noqa: E402
from repro_torch.optim import compression  # noqa: E402
from repro_torch.optim.adamw import global_norm, leaf_order  # noqa: E402
from repro_torch.parity import assert_close, params_from_jax, tree_from_state  # noqa: E402


LR = 1e-2
PARAM_ATOL = LR / 100
RECURRENT_TOL = {"metrics": 1e-4, "params": LR / 10}  # rwkv6, zamba2: see 3. above


def _flat(tree, prefix=""):
    for k, v in sorted(tree.items()):
        yield from _flat(v, f"{prefix}{k}.") if isinstance(v, dict) else [(prefix + k, v)]


# ---------------------------------------------------------------------------
# 1. AdamW


def test_adamw_reference_step():
    cfg = AdamWConfig(lr=0.1, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0, clip_norm=1e9)
    params = {"w": torch.tensor([1.0, -2.0])}
    state = adamw_init(params)
    new_p, state, metrics = adamw_update(cfg, params, {"w": torch.tensor([0.5, 0.5])}, state)
    m, v = 0.1 * 0.5, 0.001 * 0.25
    want = 1.0 - 0.1 * (m / 0.1) / (np.sqrt(v / 0.001) + 1e-8)
    np.testing.assert_allclose(float(new_p["w"][0]), want, rtol=1e-5)
    assert int(state["step"]) == 1 and state["step"].dtype == torch.int32
    assert torch.equal(params["w"], torch.tensor([1.0, -2.0]))  # functional: the input is unchanged
    np.testing.assert_allclose(float(metrics["grad_norm"]), np.sqrt(0.5), rtol=1e-6)


def _random_tree(seed=0):
    """A reference-shaped tree (a 3-layer stack, nested and top-level
    leaves) and the port's flat dict of the same values."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    tree = {"embed": r(10, 4), "final_norm": r(4),
            "layers": {"attn": {"wq": r(3, 4, 4), "wo": r(3, 4, 4)}, "ln1": r(3, 4),
                       "mlp": {"w_up": r(3, 4, 8)}}}
    return tree, params_from_jax(tree)


def test_adamw_update_matches_reference_on_a_random_tree():
    jtree, params = _random_tree(0)
    gtree, grads = _random_tree(1)
    kw = dict(lr=0.01, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=0.5)
    jstate = jax_adamw_init(jax.tree.map(jnp.asarray, jtree))
    state = adamw_init(params)
    jp, jg = jax.tree.map(jnp.asarray, jtree), jax.tree.map(jnp.asarray, gtree)
    for step in range(3):  # the moments and bias corrections carry over
        jp, jstate, jm = jax_adamw_update(JaxAdamWConfig(**kw), jp, jg, jstate)
        params, state, m = adamw_update(AdamWConfig(**kw), params, grads, state)
        assert_close(m["grad_norm"], jm["grad_norm"], atol=1e-6, rtol=1e-6, what="grad_norm")
        got = dict(_flat(tree_from_state(params)))
        for name, want in _flat(jax.tree.map(np.asarray, jp)):
            assert_close(got[name], want, atol=1e-6, rtol=1e-6, what=f"step {step} {name}")
        for k in ("m", "v"):
            got = dict(_flat(tree_from_state(state[k])))
            for name, want in _flat(jax.tree.map(np.asarray, jstate[k])):
                assert_close(got[name], want, atol=1e-7, rtol=1e-6, what=f"{k} {name}")
    assert float(jm["grad_norm"]) > 0.5  # the clip was active


def test_global_norm_sums_in_the_reference_leaf_order():
    gtree, grads = _random_tree(2)
    order = leaf_order(grads)
    assert order[0] == ["embed"] and order[1] == ["final_norm"]
    assert order[2] == [f"layers.{i}.attn.wo" for i in range(3)]  # one leaf: the stack
    want = [k for k, _ in _flat(gtree)]
    assert [".".join(["layers"] + g[0].split(".")[2:]) if g[0].startswith("layers.") else g[0]
            for g in order] == want
    assert_close(global_norm(grads), jax_global_norm(jax.tree.map(jnp.asarray, gtree)), atol=0,
                 rtol=1e-6, what="global norm")


def test_warmup_cosine_matches_reference():
    steps = np.arange(0, 40, dtype=np.int32)
    want = jax_warmup_cosine(5, 30, 0.1)(jnp.asarray(steps))
    got = warmup_cosine(5, 30, 0.1)(torch.from_numpy(steps))
    assert_close(got, want, atol=1e-7, rtol=1e-6, what="warmup_cosine")


# ---------------------------------------------------------------------------
# 2. int8 compression


@pytest.mark.parametrize("shape", [(256,), (1000,), (7, 33)])
def test_compress_int8_codes_and_scales_bit_exact(shape):
    x = (np.random.default_rng(3).standard_normal(shape) * 3.0).astype(np.float32)
    x.reshape(-1)[5] = 0.5 * x.reshape(-1)[:256].max()  # halves meet round-half-to-even
    codes, scale, sh = compression.compress_int8(torch.from_numpy(x))
    jcodes, jscale, jsh = jax_compression.compress_int8(jnp.asarray(x))
    assert codes.dtype == torch.int8 and tuple(sh) == tuple(jsh)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    y = compression.decompress_int8(codes, scale, sh)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jax_compression.decompress_int8(jcodes, jscale, jsh)))
    assert float((torch.from_numpy(x) - y).abs().max()) / float(np.abs(x).max()) < 0.02  # ~1/127


def test_error_feedback_accumulates():
    """EF: compressing the same grad repeatedly converges (the residual
    shrinks), and each payload is the reference's bit for bit."""
    g = np.random.default_rng(1).standard_normal(64).astype(np.float32)
    grads, jgrads = {"w": torch.from_numpy(g)}, {"w": jnp.asarray(g)}
    res, jres = compression.init_residuals(grads), jax_compression.init_residuals(jgrads)
    total = torch.zeros(64)
    for _ in range(8):
        payload, res = compression.ef_compress_tree(grads, res)
        jpayload, jres = jax_compression.ef_compress_tree(jgrads, jres)
        np.testing.assert_array_equal(payload["w"][0].numpy(), np.asarray(jpayload["w"][0]))
        total = total + compression.ef_decompress_tree(payload)["w"]
    np.testing.assert_allclose((total / 8).numpy(), g, atol=0.02)


# ---------------------------------------------------------------------------
# 3. make_train_step


def _batch(cfg, b=4, s=8, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal((b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return batch


@pytest.fixture(scope="module", params=["smollm-360m", "rwkv6-7b", "zamba2-1.2b", "whisper-base"])
def arch_steps(request):
    """The reference's two jitted steps (grad_accum 2) from seed-1 weights,
    and the port's model, optimizer state and step from the same weights."""
    jcfg = dataclasses.replace(jax_config(request.param).reduced(), grad_accum=2)
    japi = jax_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(1))
    opt = JaxAdamWConfig(lr=LR, clip_norm=0.5)
    step = jax.jit(jax_train_step(japi, opt))
    jstate = jax_adamw_init(jparams)
    batches = [_batch(jcfg, seed=s) for s in (0, 1)]
    jp, jmetrics = jparams, []
    for b in batches:
        jp, jstate, m = step(jp, jstate, {k: jnp.asarray(v) for k, v in b.items()})
        jmetrics.append(jax.tree.map(np.asarray, m))
    return {"arch": request.param, "init": jax.tree.map(np.asarray, jparams), "batches": batches,
            "final": jax.tree.map(np.asarray, jp), "metrics": jmetrics, "opt": AdamWConfig(lr=LR, clip_norm=0.5)}


def _port(arch, init, grad_accum):
    api = get_model(dataclasses.replace(get_config(arch).reduced(), grad_accum=grad_accum))
    model = api.init(0, device="cpu")
    model.load_state_dict(params_from_jax(init), strict=True)
    return api, model


def test_two_steps_with_grad_accum_match_reference(arch_steps):
    ref = arch_steps
    api, model = _port(ref["arch"], ref["init"], 2)
    recurrent = api.cfg.family in ("ssm", "hybrid")
    step = make_train_step(api, ref["opt"])
    state = adamw_init({n: p.detach() for n, p in trainable(model).items()})
    for i, b in enumerate(ref["batches"]):
        model, state, m = step(model, state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert sorted(m) == sorted(ref["metrics"][i]), (sorted(m), sorted(ref["metrics"][i]))
        tol = RECURRENT_TOL["metrics"] if recurrent and i > 0 else 1e-5
        for k, want in ref["metrics"][i].items():
            assert m[k].dtype == torch.float32 and m[k].ndim == 0, k
            assert_close(m[k], want, atol=tol, rtol=tol, what=f"step {i} {k}")
    assert int(state["step"]) == 2
    assert not any(p.requires_grad for p in model.parameters())  # serving sees none
    got = dict(_flat(tree_from_state(model.state_dict())))
    moved = 0.0
    atol = RECURRENT_TOL["params"] if recurrent else PARAM_ATOL
    for name, want in _flat(ref["final"]):
        assert_close(got[name], want, atol=atol, rtol=2e-4, what=name)
        moved = max(moved, float(np.abs(want - dict(_flat(ref["init"]))[name]).max()))
    assert moved > 100 * PARAM_ATOL  # the steps moved the parameters by far more than the tolerance


def test_grad_accum_matches_single_batch(arch_steps):
    """grad_accum=2 gives the update of one batch of the same rows."""
    ref = arch_steps
    out = {}
    for ga in (1, 2):
        api, model = _port(ref["arch"], ref["init"], ga)
        state = adamw_init({n: p.detach() for n, p in trainable(model).items()})
        model, _, m = make_train_step(api, ref["opt"])(
            model, state, {k: torch.from_numpy(v) for k, v in ref["batches"][0].items()})
        out[ga] = (m, {n: p.detach().clone() for n, p in model.state_dict().items()})
    assert_close(out[1][0]["loss"], out[2][0]["loss"], atol=0, rtol=1e-5, what="loss")
    for name, a in out[1][1].items():
        assert_close(a, out[2][1][name], atol=PARAM_ATOL, rtol=2e-4, what=name)


def _family_batch(cfg, b=4, s=8, seed=0):
    """``_batch`` with vlm's inputs: embeds (B, S, D) and (3, B, S) M-RoPE
    positions (each row's three channels offset apart) in place of tokens."""
    batch = _batch(cfg, b, s, seed)
    if cfg.family == "vlm":
        rng = np.random.default_rng(seed + 1)
        del batch["tokens"]
        batch["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        batch["mrope_positions"] = (np.arange(s)[None, None, :] + rng.integers(0, 4, (3, b, 1))).astype(np.int32)
    return batch


def test_train_step_refuses_sharding_specs(tmp_path):
    """Sharding specs train every family across a mesh (compute specs other
    than ``param_specs`` are refused). On a 1-rank mesh, at the pooled
    specs, two steps of reduced smollm-360m, qwen2-vl-7b, zamba2-1.2b and
    whisper-base (one micro-batch each) are each the plain steps bit for
    bit (each rank's products are the plain ops on its local shards)."""
    import _torch_mesh_ranks as ranks
    from repro_torch.core import pooling
    from repro_torch.launch import mesh as meshlib

    api = get_model(get_config("smollm-360m").reduced())
    with pytest.raises(ValueError, match="param_specs"):
        make_train_step(api, AdamWConfig(), compute_specs={})
    with ranks.one_rank_mesh(str(tmp_path / "store")) as mesh:
        for arch in ("smollm-360m", "qwen2-vl-7b", "zamba2-1.2b", "whisper-base"):
            api = get_model(dataclasses.replace(get_config(arch).reduced(), grad_accum=1))
            batch = {k: torch.from_numpy(v) for k, v in _family_batch(api.cfg, b=4, s=8).items()}
            plain = api.init(0, device="cpu")
            state = adamw_init(trainable(plain))
            step = make_train_step(api, AdamWConfig(lr=LR))
            want = []
            for _ in range(2):
                plain, state, m = step(plain, state, batch)
                want.append(m)
            specs = pooling.pooled_specs(api.param_specs(), api.abstract_params(), mesh)
            placed = meshlib.place_params(api.init(0, device="cpu"), mesh, specs)
            pstate = adamw_init(trainable(placed))
            step = make_train_step(api, AdamWConfig(lr=LR), compute_specs=api.param_specs(), storage_specs=specs)
            got = []
            for _ in range(2):
                placed, pstate, m = step(placed, pstate, batch)
                got.append(m)
            assert all(meshlib.is_dtensor(p) for p in placed.parameters()), arch
            for name, p in placed.named_parameters():
                assert torch.equal(p.to_local(), dict(plain.named_parameters())[name]), (arch, name)
                assert torch.equal(pstate["v"][name].to_local(), state["v"][name]), (arch, name)
            for g, w in zip(got, want):
                assert {k: float(v) for k, v in g.items()} == {k: float(v) for k, v in w.items()}, arch


def test_vlm_micro_batches_split_mrope_positions_on_their_batch_axis():
    """A vlm step with grad_accum 2: the (3, B, S) positions split on axis
    1, as the reference's (``api.py:214-219``); the loss is the mean of the
    two halves' losses."""
    api = get_model(dataclasses.replace(get_config("qwen2-vl-7b").reduced(), grad_accum=2))
    rng = np.random.default_rng(4)
    b, s = 4, 8
    pos = np.stack([np.tile(np.arange(s), (b, 1)) + c * np.arange(b)[:, None] for c in range(3)])
    batch = {"embeds": torch.from_numpy(rng.standard_normal((b, s, api.cfg.d_model)).astype(np.float32)),
             "mrope_positions": torch.from_numpy(pos.astype(np.int32)),
             "labels": torch.from_numpy(rng.integers(0, api.cfg.vocab_size, (b, s)).astype(np.int32))}
    model = api.init(0, device="cpu")
    with torch.no_grad():
        halves = [api.loss(model, {"embeds": batch["embeds"][i:i + 2],
                                   "mrope_positions": batch["mrope_positions"][:, i:i + 2],
                                   "labels": batch["labels"][i:i + 2]})[1]["loss"] for i in (0, 2)]
    state = adamw_init({n: p.detach() for n, p in trainable(model).items()})
    _, _, m = make_train_step(api, AdamWConfig())(model, state, batch)
    assert_close(m["loss"], (halves[0] + halves[1]) / 2, atol=1e-6, rtol=1e-6, what="loss")


# ---------------------------------------------------------------------------
# 4. the plain versions differentiate on the CPU


def _grad_case(name):
    rng = np.random.default_rng(7)
    r = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    if name == "flash_attention":
        from repro_torch.kernels.flash_attention import flash_attention
        x = [r(1, 4, 8, 64), r(1, 2, 8, 64), r(1, 2, 8, 64)]
        return x, lambda q, k, v: flash_attention(q, k, v, causal=True)
    if name == "paged_attention":
        from repro_torch.kernels.paged_attention import cache_as_pages, paged_attention
        x = [r(2, 4, 64), r(2, 2, 32, 64), r(2, 2, 32, 64)]

        def fn(q, kc, vc):
            kp, vp, table = cache_as_pages(kc, vc, 16)
            return paged_attention(q, kp, vp, table, torch.tensor([5, 32], dtype=torch.int32))
        return x, fn
    if name == "wkv6":
        from repro_torch.kernels.rwkv6_scan import wkv6_chunked
        b, t, h, hd = 1, 12, 2, 16
        x = [r(b, t, h, hd), r(b, t, h, hd), r(b, t, h, hd), -torch.rand(b, t, h, hd), r(h, hd)]
        return x, lambda *a: wkv6_chunked(*a)[0]
    if name == "ssd":
        from repro_torch.kernels.mamba2_scan import ssd_chunked
        b, t, h, p, n = 1, 12, 2, 16, 16
        x = [r(b, t, h, p), torch.rand(b, t, h) * 0.5, -torch.rand(h), r(b, t, n), r(b, t, n), r(h)]
        return x, lambda *a: ssd_chunked(*a)[0]
    from repro_torch.kernels.tiered_gather import gather_rows, tiered_lookup_counted
    if name == "gather_rows":
        return [r(16, 24), r(16)], lambda src, sc: gather_rows(src, torch.tensor([3, 0, 3, 15], dtype=torch.int32), sc)
    hot = r(4, 24)
    cold_q = torch.from_numpy(rng.integers(-127, 128, (16, 24)).astype(np.int8))
    tier = torch.tensor([0] * 4 + [1] * 12, dtype=torch.int32)
    slot = torch.tensor([0, 1, 2, 3] + list(range(4, 16)), dtype=torch.int32)
    ids = torch.tensor([0, 5, 2, 9], dtype=torch.int32)
    return [hot, r(16)], lambda h, s: tiered_lookup_counted(h, cold_q, s, tier, slot, ids)[0]


@pytest.mark.parametrize("name", ["flash_attention", "paged_attention", "wkv6", "ssd", "gather_rows",
                                  "tiered_lookup"])
def test_plain_versions_still_differentiate_on_the_cpu(name):
    inputs, fn = _grad_case(name)
    for t in inputs:
        t.requires_grad_(True)
    out = fn(*inputs)
    assert out.requires_grad
    grads = torch.autograd.grad(out.float().square().sum(), inputs)
    assert all(torch.isfinite(g).all() for g in grads)
    assert any(float(g.abs().max()) > 0 for g in grads)
