"""The port's training forward against the JAX package's, on the CPU.

1. The losses: ``cross_entropy`` and the sequence-chunked ``fused_ce_loss``
   (chunk 4, an ignored label, a padded vocabulary) against the
   reference's, values to 1e-5, gradients w.r.t. h and w to 1e-4 of each
   (the reference's own fused-vs-plain tolerance).
2. ``AttentionFn`` against ``jax.vjp`` of ``attention_chunked`` (the
   reference's custom VJP), f32, to 1e-5: output, lse, dq, dk, dv, over
   GQA, causal, bidirectional, q_offset > 0, a key length that is not a
   multiple of block_k, and fully masked rows (q_offset < 0: the
   reference's lse is m + log(l) with m = -1e30 there, so about -1e30, and
   every gradient stays finite). Its backward also against autograd
   through the plain eager ``attention_chunked``, and the remat policies
   against no remat.
3. The model: ``features`` through the head equals ``forward``; then
   ``ModelAPI.loss``, its metrics and every gradient leaf against the
   reference's for tiny smollm-360m, qwen2.5-3b, granite-moe-3b,
   qwen2-vl-7b, rwkv6-7b (its scan through ``WKV6Fn``), zamba2-1.2b
   (``SSDFn``, the cast shared block, remat nested) and whisper-base (the
   encoder, non-causal attention over 16 frames, the tied head), f32
   compute, and moe routing under grad bit-equal to routing without.

Gradient leaves are held to 2e-5 of the leaf's largest magnitude (plus
1e-4 relative): both sides compute in f32 and sum in other orders (XLA's
fused reductions against torch's), which moves a gradient by a few ulps of
the largest term summed into it; the largest such miss seen is 1.5e-6 of
its leaf's scale, and 2e-5 leaves some ten times that.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models.api import get_model as jax_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import common, moe, rwkv6, transformer, whisper, zamba2  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.parity import assert_close, params_from_jax, tree_from_state  # noqa: E402

VALUE_TOL = 1e-5
GRAD_RTOL = 1e-4
LEAF_SCALE_TOL = 2e-5
ARCHS = ["smollm-360m", "qwen2.5-3b", "granite-moe-3b-a800m", "qwen2-vl-7b", "rwkv6-7b", "zamba2-1.2b",
         "whisper-base"]


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a, copy=True))
    return t.requires_grad_(grad)


# ---------------------------------------------------------------------------
# 1. the losses


def _ce_inputs(seed=0, b=2, s=16, d=8, v=50, vp=64):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    w = rng.standard_normal((d, vp)).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    labels[0, 0] = -1  # ignored
    return h, w, labels, v


@pytest.mark.parametrize("fused", [False, True])
def test_losses_and_their_grads_match_reference(fused):
    h, w, labels, v = _ce_inputs()

    def jax_loss(h, w):
        if fused:
            return jax_common.fused_ce_loss(h, w, jnp.asarray(labels), v, chunk=4)
        logits = jnp.einsum("bsd,dv->bsv", h, w, preferred_element_type=jnp.float32)
        return jax_common.cross_entropy(logits, jnp.asarray(labels), v)

    (jl, jm), (jgh, jgw) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(h), jnp.asarray(w))
    th, tw = _t(h, True), _t(w, True)
    if fused:
        tl, tm = common.fused_ce_loss(th, tw, torch.from_numpy(labels), v, chunk=4)
    else:
        tl, tm = common.cross_entropy(common.matmul_f32(th, tw), torch.from_numpy(labels), v)
    assert_close(tl, jl, atol=VALUE_TOL, rtol=VALUE_TOL, what="loss")
    assert sorted(tm) == sorted(jm)
    for k in jm:
        assert_close(tm[k], jm[k], atol=VALUE_TOL, rtol=VALUE_TOL, what=k)
    assert float(tm["tokens"]) == labels.size - 1
    gh, gw = torch.autograd.grad(tl, (th, tw))
    assert_close(gh, jgh, atol=1e-6, rtol=GRAD_RTOL, what="dL/dh")
    assert_close(gw, jgw, atol=1e-6, rtol=GRAD_RTOL, what="dL/dw")


def test_fused_ce_pads_a_ragged_sequence_as_the_reference():
    """S = 10 over chunks of 4: the last chunk is padded with ignored labels."""
    h, w, labels, v = _ce_inputs(seed=1, s=10)
    jl, jm = jax_common.fused_ce_loss(jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels), v, chunk=4)
    tl, tm = common.fused_ce_loss(_t(h), _t(w), torch.from_numpy(labels), v, chunk=4)
    assert_close(tl, jl, atol=VALUE_TOL, rtol=VALUE_TOL, what="loss")
    assert float(tm["tokens"]) == float(jm["tokens"]) == labels.size - 1


# ---------------------------------------------------------------------------
# 2. AttentionFn

# (b, hq, hkv, lq, lk, causal, q_offset, block_k, bidirectional)
ATTN_CASES = {
    "gqa_causal": (2, 6, 2, 24, 24, True, 0, 8, False),
    "bidirectional": (1, 4, 2, 16, 16, True, 0, 8, True),
    "non_causal_ragged_lk": (1, 4, 1, 12, 21, False, 0, 8, False),
    "q_offset": (2, 4, 2, 8, 20, True, 12, 8, False),
    "ragged_lk_causal_offset": (1, 6, 3, 10, 27, True, 17, 8, False),
    "fully_masked_rows": (1, 4, 2, 8, 12, True, -3, 8, False),
}


def _attn_inputs(case, seed=0):
    b, hq, hkv, lq, lk, *_ = ATTN_CASES[case]
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32)
                   for s in ((b, hq, lq, 16), (b, hkv, lk, 16), (b, hkv, lk, 16), (b, hq, lq, 16)))
    return q, k, v, do


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_fn_matches_the_reference_vjp(case):
    *_, causal, q_offset, block_k, bidir = ATTN_CASES[case]
    q, k, v, do = _attn_inputs(case)
    kw = dict(causal=causal, q_offset=q_offset, block_k=block_k, bidirectional=bidir)
    jout, vjp = jax.vjp(lambda q, k, v: jax_common.attention_chunked(q, k, v, **kw),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    _, jlse = jax_common._attention_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                                             q_offset, block_k, bidir)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = common.attention_train(tq, tk, tv, **kw)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "AttentionFnBackward"
    assert_close(out, jout, atol=VALUE_TOL, what="out")
    _, lse = common._attention_fwd_impl(tq.detach(), tk.detach(), tv.detach(), causal, q_offset,
                                        block_k, bidir)
    assert_close(lse, jlse, atol=VALUE_TOL, rtol=VALUE_TOL, what="lse")
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    for name, g, jg in zip("qkv", grads, jgrads):
        assert torch.isfinite(g).all(), name
        assert_close(g, jg, atol=VALUE_TOL, what=f"d{name}")
    if case == "fully_masked_rows":  # rows 0-2 see no key: the reference's lse there
        assert float(lse[..., :3].max()) <= -1e29 and float(lse[..., 3:].min()) > -1e29


@pytest.mark.parametrize("case", ["gqa_causal", "q_offset", "non_causal_ragged_lk"])
def test_attention_fn_backward_is_autograd_through_the_eager_attention(case):
    *_, causal, q_offset, block_k, bidir = ATTN_CASES[case]
    kw = dict(causal=causal, q_offset=q_offset, block_k=block_k, bidirectional=bidir)
    q, k, v, do = _attn_inputs(case, seed=1)
    want_in = [_t(a, True) for a in (q, k, v)]
    want = torch.autograd.grad(common.attention_chunked(*want_in, **kw), want_in, torch.from_numpy(do))
    got_in = [_t(a, True) for a in (q, k, v)]
    got = torch.autograd.grad(common.attention_train(*got_in, **kw), got_in, torch.from_numpy(do))
    for name, g, w in zip("qkv", got, want):
        assert_close(g, w, atol=VALUE_TOL, what=f"d{name}")


def test_attend_takes_the_function_only_under_grad():
    from repro_torch.models import attention

    q, k, v, _ = _attn_inputs("gqa_causal")
    tq, tk, tv = _t(q, True), _t(k), _t(v)
    assert type(attention.attend(tq, tk, tv, causal=True, block_k=8).grad_fn).__name__ == "AttentionFnBackward"
    with torch.no_grad():
        plain = attention.attend(tq, tk, tv, causal=True, block_k=8)
    assert plain.grad_fn is None
    assert torch.equal(plain, common.attention_chunked(_t(q), tk, tv, block_k=8))


# ---------------------------------------------------------------------------
# 3. the model


def _flat(tree, prefix=""):
    for k, v in sorted(tree.items()):
        yield from _flat(v, f"{prefix}{k}.") if isinstance(v, dict) else [(prefix + k, v)]


def _batch(cfg, seed=0, b=2, s=16):
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        batch = {"embeds": rng.standard_normal((b, s, cfg.d_model)).astype(np.float32),
                 "mrope_positions": np.tile(np.arange(s)[None, None], (3, b, 1)).astype(np.int32)}
        batch["mrope_positions"][1:, :, 4:] += 3  # an image grid: channels apart
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal((b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    batch["labels"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    batch["labels"][1, :3] = -1
    return batch


@pytest.fixture(scope="module", params=ARCHS)
def loss_pair(request):
    """The reference's loss, metrics and gradients on one batch (one JAX
    run), and the port's model holding the same weights."""
    arch = request.param
    jcfg = jax_config(arch).reduced()
    japi = jax_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(1))
    tapi = get_model(get_config(arch).reduced())
    model = tapi.init(0, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)), strict=True)
    batch = _batch(tapi.cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jm), jg = jax.jit(jax.value_and_grad(lambda p: japi.loss(p, jb), has_aux=True))(jparams)
    return {"arch": arch, "japi": japi, "jparams": jparams, "tapi": tapi, "model": model,
            "batch": batch, "loss": jl, "metrics": jm, "grads": dict(_flat(jax.tree.map(np.asarray, jg)))}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_loss_metrics_and_every_grad_leaf_match_reference(loss_pair):
    lp = loss_pair
    tapi, model = lp["tapi"], lp["model"]
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    try:
        loss, metrics = tapi.loss(model, _torch_batch(lp["batch"]))
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True, materialize_grads=True)
    finally:
        for p in params.values():
            p.requires_grad_(False)
    assert_close(loss, lp["loss"], atol=VALUE_TOL, rtol=VALUE_TOL, what="loss")
    assert sorted(metrics) == sorted(lp["metrics"]), (sorted(metrics), sorted(lp["metrics"]))
    assert ("aux_loss" in metrics) == (tapi.cfg.family == "moe")
    for k, v in lp["metrics"].items():
        assert_close(metrics[k], v, atol=VALUE_TOL, rtol=VALUE_TOL, what=k)
    got = dict(_flat(tree_from_state(dict(zip(params, grads)))))
    assert sorted(got) == sorted(lp["grads"])
    nonzero = 0
    for name, want in lp["grads"].items():
        scale = float(np.abs(want).max())
        assert_close(got[name], want, atol=LEAF_SCALE_TOL * scale + 1e-9, rtol=GRAD_RTOL,
                     what=f"{lp['arch']} grad {name}")
        nonzero += scale > 0
    assert nonzero >= len(got) - 1  # vlm: the unused embedding's gradient is 0 on both sides


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen2.5-3b", "qwen2-vl-7b", "rwkv6-7b", "zamba2-1.2b",
                                  "whisper-base"])
def test_features_through_the_head_is_forward(arch):
    """forward() equals features() through the head (the reference's
    ``test_features_matches_forward_logits``): serving and loss agree."""
    tapi = get_model(get_config(arch).reduced())
    model, cfg = tapi.init(1, device="cpu"), tapi.cfg
    tb = _torch_batch(_batch(cfg, seed=3))
    mod = {"ssm": rwkv6, "hybrid": zamba2, "audio": whisper}.get(cfg.family, transformer)
    if cfg.family == "vlm":
        args = dict(embeds=tb["embeds"], mrope_positions=tb["mrope_positions"])
    elif cfg.family == "audio":
        args = dict(tokens=tb["tokens"], frames=tb["frames"])
    else:
        args = dict(tokens=tb["tokens"])
    logits = mod.forward(model, cfg, **args)
    h, w = mod.features(model, cfg, **args)
    assert_close(common.matmul_f32(h, w.to(h.dtype)), logits, atol=1e-5, rtol=1e-5, what="logits")


@pytest.mark.parametrize("backend", ["einsum", "sort"])
def test_moe_routing_under_grad_is_routing_without(backend):
    """The same experts, the same capacity drops, bit for bit, with the
    layer's weights requiring grad under grad mode and without, on inputs
    that overflow an expert's capacity."""
    cfg = get_config("granite-moe-3b-a800m").reduced()
    model = get_model(cfg).init(0, device="cpu")
    fn = moe.moe_einsum if backend == "einsum" else moe.moe_sort
    rng = np.random.default_rng(5)
    lean = rng.standard_normal(cfg.d_model)
    x = (rng.standard_normal((2, 24, cfg.d_model)) + 2.0 * lean).astype(np.float32)
    layer = model.layers[0]
    with torch.no_grad():
        want = moe._route(layer.tree(torch.float32)["router"], cfg, _t(x))
        want_out, want_keep = fn(layer.tree(torch.float32), cfg, _t(x))
    for p in layer.parameters():
        p.requires_grad_(True)
    try:
        tree = layer.tree(torch.float32)
        xg = _t(x, True)
        got = moe._route(tree["router"], cfg, xg)
        out, keep = fn(tree, cfg, xg)
        y, aux = moe.moe_ffn(tree, cfg, xg, backend, with_aux=True)
        assert got[0].requires_grad and out.requires_grad and aux.requires_grad
        assert torch.equal(got[1], want[1]) and torch.equal(got[0].detach(), want[0])
        assert torch.equal(keep, want_keep) and torch.equal(out.detach(), want_out)
        assert 0 < int((~keep).sum()) < keep.numel(), "no slot overflowed: the inputs test nothing"
        assert torch.isfinite(torch.autograd.grad(y.sum() + aux, xg)[0]).all()
    finally:
        for p in layer.parameters():
            p.requires_grad_(False)


@pytest.mark.parametrize("remat,policy,every", [(False, "nothing", 1), (True, "dots", 1),
                                                (True, "nothing", 2)])
def test_remat_policies_give_the_gradients_of_no_remat(remat, policy, every):
    """The default (remat on, policy "nothing", every layer) against remat
    off, the "dots" policy and two layers a checkpoint: one forward's
    arithmetic, so equal gradients."""
    cfg = get_config("smollm-360m").reduced()
    batch = _torch_batch(_batch(cfg, seed=2))

    def grads(c):
        api = get_model(c)
        model = api.init(0, device="cpu")
        params = list(model.parameters())
        for p in params:
            p.requires_grad_(True)
        loss, _ = api.loss(model, batch)
        return torch.autograd.grad(loss, params)

    base = grads(cfg)
    other = grads(dataclasses.replace(cfg, remat=remat, remat_policy=policy, remat_every=every))
    for a, b in zip(base, other):
        assert_close(a, b, atol=1e-7, rtol=1e-6, what=f"remat={remat} {policy} every {every}")

