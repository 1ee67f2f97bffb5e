"""The port's recurrent models against the JAX package's, at reduced size,
with the reference's parameters carried over by ``parity.params_from_jax``:
rwkv6-7b (ssm: the WKV6 scan) and zamba2-1.2b (hybrid: Mamba2 SSD layers
and a shared attention block).

Both sides compute in f32 (reduced configs), so logits and the f32 state
leaves agree to 1e-4 (the two frameworks sum in other orders). zamba2's
KV cache is stored in bf16 on both sides; a value whose f32 form lies near
a bf16 rounding boundary can round the other way, so it is held to one
bf16 step (2**-7 of the value). Greedy tokens must be equal.

At full width the models compute in bf16, where the reference's casts
matter: every float leaf of an rwkv6 layer and of a Mamba2 block is cast
to bf16, zamba2's shared block is not in prefill and decode. The same
reduced configs are also run with bf16 compute on both sides; see
``test_bf16_compute_matches_reference`` for their tolerances.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models.api import get_model as jax_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.mamba2_scan import LAUNCHES as SSD_LAUNCHES  # noqa: E402
from repro_torch.kernels.rwkv6_scan import LAUNCHES as WKV_LAUNCHES  # noqa: E402
from repro_torch.models import mamba2, rwkv6, zamba2  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.api import get_model, kernel_launches, make_serve_step  # noqa: E402
from repro_torch.parity import assert_close, params_from_jax  # noqa: E402

ARCHS = ["rwkv6-7b", "zamba2-1.2b"]
MODULES = {"rwkv6-7b": rwkv6, "zamba2-1.2b": zamba2}
ATOL = 1e-4
BF16_STEP = 2.0 ** -7


def _pair(arch: str, seed: int = 1, compute_dtype: str = "float32"):
    """(jax api, jax params, torch api, torch model) with identical weights.
    The reference initialises the mixers, biases, norms, decay and skip
    leaves to constants; they get seeded noise here on both sides so every
    path of the arithmetic is exercised (and each one's bf16 cast changes
    it)."""
    jcfg = dataclasses.replace(jax_config(arch).reduced(), compute_dtype=compute_dtype)
    japi = jax_model(jcfg)
    tree = jax.tree.map(np.asarray, japi.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    lay = tree["layers"]
    if arch == "rwkv6-7b":
        att = lay["att"]
        noisy = [(att, "maa_x"), (att, "maa"), (att, "w0"), (att, "u"), (att["ln_x"], "w"), (att["ln_x"], "b")]
        for name in ("w1", "w2"):  # 5x each, so the decay's LoRA term is not lost beside w0
            att[name] = att[name] * np.asarray(5.0, att[name].dtype)
    else:
        noisy = [(lay, "A_log"), (lay, "D"), (lay, "dt_bias"), (lay, "conv_b"), (lay, "norm_w")]
    for node, name in noisy:
        node[name] = (node[name] + rng.standard_normal(node[name].shape) * 0.3).astype(node[name].dtype)
    jparams = jax.tree.map(jnp.asarray, tree)
    tapi = get_model(dataclasses.replace(get_config(arch).reduced(), compute_dtype=compute_dtype))
    model = tapi.init(0, device="cpu")
    model.load_state_dict(params_from_jax(tree), strict=True)
    return japi, jparams, tapi, model


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _prefill_and_decode_match(arch: str, compute_dtype: str, tol):
    """Prefill and 8 greedy decode steps on both sides: logits and f32 state
    leaves within ``tol(reference)``, bf16 KV leaves within one bf16 step,
    and equal tokens wherever the reference's two best logits are more than
    twice the logits' tolerance apart, so that no argmax within tolerance
    can differ (both sides then decode the reference's token). Returns how
    many of the 2 x 9 tokens were compared."""
    japi, jparams, tapi, model = _pair(arch, compute_dtype=compute_dtype)
    cfg = tapi.cfg
    tokens = _tokens(cfg, (2, 13))
    max_len = 32
    lt, ct = tapi.prefill(model, {"tokens": torch.from_numpy(tokens)}, max_len=max_len)
    lj, cj = jax.jit(lambda p, t: japi.prefill(p, {"tokens": t}, max_len=max_len))(
        jparams, jnp.asarray(tokens))
    assert lt.dtype == torch.float32 and lt.shape == (2, 13, cfg.padded_vocab)
    assert_close(lt, lj, atol=tol(lj), what="prefill logits")
    assert sorted(ct) == sorted(cj)
    for key in cj:
        assert ct[key].shape == tuple(cj[key].shape), key
        if key in ("k", "v"):
            assert ct[key].dtype == torch.bfloat16
            assert_close(ct[key], cj[key], atol=1e-6, rtol=BF16_STEP, what=f"prefill cache {key}")
        elif key == "lengths":
            np.testing.assert_array_equal(ct[key].numpy(), np.asarray(cj[key]))
        else:
            assert ct[key].dtype == torch.float32
            assert_close(ct[key], cj[key], atol=tol(cj[key]), what=f"prefill cache {key}")
    # 8 greedy decode steps: the port through make_serve_step, the reference
    # through its (jitted) decode and the same first-`vocab` argmax
    serve_t = make_serve_step(tapi, vocab=cfg.vocab_size)
    decode_j = jax.jit(japi.decode)
    compared = 0

    def greedy(port, ref, what):
        nonlocal compared
        top = np.sort(np.asarray(ref)[:, -1, : cfg.vocab_size], axis=-1)
        sure = top[:, -1] - top[:, -2] > 2 * tol(ref)
        want = np.argmax(np.asarray(ref)[:, -1, : cfg.vocab_size], axis=-1).astype(np.int32)[:, None]
        np.testing.assert_array_equal(np.asarray(port)[sure], want[sure], err_msg=what)
        compared += int(sure.sum())
        return want

    nxt = greedy(torch.argmax(lt[:, -1, : cfg.vocab_size], dim=-1)[:, None], lj, "prefill")
    for step in range(8):
        tok_t, tok_j = torch.from_numpy(nxt), jnp.asarray(nxt)
        logits_t, _ = tapi.decode(model, {k: v.clone() for k, v in ct.items()}, tok_t)
        logits_j, cj = decode_j(jparams, cj, tok_j)
        assert_close(logits_t, logits_j, atol=tol(logits_j), what=f"decode logits, step {step}")
        tok_t, ct = serve_t(model, ct, tok_t)
        nxt = greedy(tok_t, logits_j, f"step {step}")
    for key in cj:
        if key in ("k", "v"):
            assert_close(ct[key], cj[key], atol=1e-6, rtol=BF16_STEP, what=f"decoded cache {key}")
        else:
            assert_close(ct[key], cj[key], atol=tol(cj[key]), what=f"decoded cache {key}")
    assert int(ct["lengths"][0]) == 13 + 8
    return compared


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    assert _prefill_and_decode_match(arch, "float32", lambda ref: ATOL) == 2 * 9


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_compute_matches_reference(arch, monkeypatch):
    """The reduced models with bf16 compute, as at full width, on both sides.

    A bf16 pipeline turns the two frameworks' f32 summation orders into
    whole bf16 steps: a value near a rounding boundary rounds the other way
    and the step travels on through the next products (rwkv6's logits move
    by some 0.03 at a largest logit of 3.4, about two bf16 steps of it). So
    logits and the f32 state leaves are held to 4 bf16 steps of the
    reference's largest magnitude, and greedy tokens must be equal where
    no argmax within that tolerance could differ (at least 4 of 18). The
    casts themselves are held tighter by
    ``test_bf16_first_layer_matches_reference``. zamba2's shared
    block runs its weights uncast in prefill and decode, on both sides, so
    its q, k and v are f32 there."""
    seen = []
    for name in ("attend", "attend_decode"):
        orig = getattr(attention, name)

        def spy(q, k, v, *a, _orig=orig, _name=name, **kw):
            seen.append((_name, q.dtype, k.dtype, v.dtype))
            return _orig(q, k, v, *a, **kw)

        monkeypatch.setattr(attention, name, spy)
    tol = lambda ref: 4 * BF16_STEP * float(np.abs(np.asarray(ref, np.float32)).max())
    assert _prefill_and_decode_match(arch, "bfloat16", tol) >= 4
    if arch == "zamba2-1.2b":
        f32 = torch.float32
        assert {s[1:] for s in seen if s[0] == "attend"} == {(f32, f32, f32)}, seen
        # decode: an f32 query over the bf16 cache
        assert {s[1:] for s in seen if s[0] == "attend_decode"} == {(f32, torch.bfloat16, torch.bfloat16)}, seen
    else:
        assert not seen


def _spy(monkeypatch, module, name, into: list):
    """Record (arguments, result) of each call of ``module.name``."""
    orig = getattr(module, name)

    def spy(*a, **kw):
        out = orig(*a, **kw)
        into.append((a, out))
        return out

    monkeypatch.setattr(module, name, spy)


def _bf16_equal_but_rare_flips(actual, expected, what: str):
    """A bf16 result of f32 work summed in another order: equal but where
    an f32 value lay at a rounding boundary, and there one bf16 step off
    (at most 1% of the values)."""
    a, e = actual.float().numpy(), np.asarray(expected).astype(np.float32)
    assert a.shape == e.shape, what
    assert (a != e).mean() <= 0.01, f"{what}: {(a != e).mean():.4f} of the values differ"
    assert_close(a, e, atol=1e-6, rtol=BF16_STEP, what=what)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_first_layer_matches_reference(arch, monkeypatch):
    """The first layer of a bf16-compute prefill, held against the
    reference's first layer run on its own (its prefill scans the layers
    inside one jitted program). Every float leaf of the layer is cast to
    bf16 first, so a leaf the port left uncast, or cast where the
    reference does not, moves a value by a relative 2**-9 or more, and
    most of the layer's bf16 output a step. Held: the layer's bf16 output
    equal but for rare rounding flips; the scan's inputs: rwkv6's bonus u
    equal, its decay exp(lw) within 2e-7 (some 3 f32 steps at its values
    near 1), r, k and v (bf16 products) within one bf16 step; the Mamba2
    block's A and D equal, x, dt, B and C (f32 on cast leaves) within
    1e-5."""
    import repro.models.mamba2 as jmamba2
    import repro.models.rwkv6 as jrwkv6

    japi, jparams, tapi, model = _pair(arch, compute_dtype="bfloat16")
    jcfg = japi.cfg
    layer0 = jax.tree.map(lambda a: a[0], jparams["layers"])
    tokens = _tokens(tapi.cfg, (2, 13))
    scan_j, scan_t, layer_t = [], [], []
    if arch == "rwkv6-7b":
        _spy(monkeypatch, jrwkv6, "wkv6", scan_j)
        _spy(monkeypatch, rwkv6, "wkv6_chunked", scan_t)
        _spy(monkeypatch, rwkv6, "_block", layer_t)
        z = jnp.zeros((2, jcfg.d_model), jnp.float32)
        out_j = jrwkv6._block(layer0, jcfg, jrwkv6._embed(jparams, jcfg, jnp.asarray(tokens)), z, z, None)
    else:
        _spy(monkeypatch, jmamba2, "ssd_scan", scan_j)
        _spy(monkeypatch, mamba2, "ssd_chunked", scan_t)
        _spy(monkeypatch, mamba2, "apply", layer_t)
        out_j = jmamba2.apply(layer0, jcfg, jnp.take(jparams["embed"], jnp.asarray(tokens), axis=0)
                              .astype(jnp.bfloat16))
    tapi.prefill(model, {"tokens": torch.from_numpy(tokens)}, max_len=16)
    assert len(scan_j) == 1 and len(scan_t) == len(layer_t) == tapi.cfg.n_layers
    assert layer_t[0][1][0].dtype == torch.bfloat16
    _bf16_equal_but_rare_flips(layer_t[0][1][0], out_j[0], "first layer's output")
    (args_t, _), (args_j, _) = scan_t[0], scan_j[0]
    if arch == "rwkv6-7b":
        (r_t, k_t, v_t, lw_t, u_t, _), (r_j, k_j, v_j, w_j, u_j, _) = args_t, args_j
        assert_close(u_t, u_j, atol=0.0, what="u")
        assert_close(torch.exp(lw_t), w_j, atol=2e-7, what="decay")
        for name, a, b in (("r", r_t, r_j), ("k", k_t, k_j), ("v", v_t, v_j)):
            assert_close(a, b, atol=1e-6, rtol=BF16_STEP, what=name)
    else:
        for name, a, b in zip(("x", "dt", "A", "B", "C", "D"), args_t, args_j):
            exact = name in ("A", "D")
            assert_close(a, b, atol=0.0 if exact else 1e-6, rtol=0.0 if exact else 1e-5, what=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_forward(arch):
    """On the port itself: the logits of a prompt's prefill and of each
    token decoded after it are the full-sequence forward's, position by
    position, and decode updates the cache's own tensors. rwkv6's state is
    f32 throughout (1e-4); zamba2's decode attends over its bf16 KV cache
    where forward keeps k and v in f32, which moves logits by some 3e-4
    (held to 1e-3)."""
    tapi = get_model(get_config(arch).reduced())
    cfg = tapi.cfg
    model = tapi.init(2, device="cpu")
    tokens = torch.from_numpy(_tokens(cfg, (2, 12), seed=3))
    full = MODULES[arch].forward(model, cfg, tokens)
    logits, cache = tapi.prefill(model, {"tokens": tokens[:, :8]}, max_len=16)
    torch.testing.assert_close(logits, full[:, :8], rtol=1e-5, atol=1e-5)
    before = {k: v.data_ptr() for k, v in cache.items() if k != "lengths"}
    for i in range(8, 12):
        step, cache = tapi.decode(model, cache, tokens[:, i:i + 1])
        tol = ATOL if arch == "rwkv6-7b" else 1e-3
        torch.testing.assert_close(step[:, 0], full[:, i], rtol=tol, atol=tol)
    assert {k: v.data_ptr() for k, v in cache.items() if k != "lengths"} == before
    assert cache["lengths"].tolist() == [12, 12]


def test_every_layer_goes_through_the_scan_op(monkeypatch):
    """rwkv6 calls wkv6_chunked once per layer per prefill and per decode,
    zamba2 ssd_chunked once per Mamba2 layer; on the CPU they launch no
    kernel."""
    calls = {"wkv6": 0, "ssd": 0}
    for mod, name, key in ((rwkv6, "wkv6_chunked", "wkv6"), (mamba2, "ssd_chunked", "ssd")):
        orig = getattr(mod, name)

        def counted(*a, _orig=orig, _key=key, **k):
            calls[_key] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    before = (WKV_LAUNCHES["wkv6"], SSD_LAUNCHES["ssd"])
    for arch, key in (("rwkv6-7b", "wkv6"), ("zamba2-1.2b", "ssd")):
        tapi = get_model(get_config(arch).reduced())
        model = tapi.init(0, device="cpu")
        _, cache = tapi.prefill(model, {"tokens": torch.arange(10)[None]}, max_len=16)
        tapi.decode(model, cache, torch.tensor([[3]], dtype=torch.int32), page_size=4)
        assert calls[key] == kernel_launches(tapi.cfg, 1, 1)[key] == 2 * tapi.cfg.n_layers, (arch, calls)
    assert (WKV_LAUNCHES["wkv6"], SSD_LAUNCHES["ssd"]) == before


def test_zamba2_decode_past_the_cache_end_drops_the_write():
    """JAX drops an out-of-range KV update in the shared block; so does the port."""
    tapi = get_model(get_config("zamba2-1.2b").reduced())
    model = tapi.init(0, device="cpu")
    cache = tapi.init_cache(2, 4, device="cpu")
    cache["lengths"] = torch.tensor([3, 4], dtype=torch.int32)
    before = cache["k"][:, 1].clone()
    logits, new = tapi.decode(model, cache, torch.tensor([[1], [2]], dtype=torch.int32))
    assert torch.isfinite(logits).all()
    assert torch.equal(new["k"][:, 1], before)
    assert new["k"][:, 0, :, 3].abs().sum() > 0
