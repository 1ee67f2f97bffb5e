"""The port's dense model against the JAX package's, at reduced size, with the
reference's parameters carried over by ``parity.params_from_jax``: forward
and prefill logits, the prefill KV cache, and 8 greedy decode steps.

Both sides compute in f32 (reduced configs), so logits agree to 1e-4 (the
two frameworks sum in other orders). The KV cache is stored in bf16 on
both sides; a value whose f32 form lies near a bf16 rounding boundary can
round the other way, so the cache is held to one bf16 step (2**-7 of the
value). The greedy tokens must be equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.models.api import get_model as jax_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.api import get_model, make_serve_step  # noqa: E402
from repro_torch.parity import assert_close, params_from_jax  # noqa: E402

LOGIT_ATOL = 1e-4
BF16_STEP = 2.0 ** -7


def _pair(arch: str, seed: int = 1):
    """(jax api, jax params, torch api, torch model) with identical weights.
    The reference initialises qkv biases to zero; they get seeded noise here
    on both sides so the bias path is exercised."""
    jcfg = jax_config(arch).reduced()
    japi = jax_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, jparams)
    if jcfg.qkv_bias:
        rng = np.random.default_rng(seed)
        for b in ("bq", "bk", "bv"):
            leaf = tree["layers"]["attn"][b]
            tree["layers"]["attn"][b] = (rng.standard_normal(leaf.shape) * 0.1).astype(leaf.dtype)
        jparams = jax.tree.map(jnp.asarray, tree)
    tapi = get_model(get_config(arch).reduced())
    model = tapi.init(0, device="cpu")
    model.load_state_dict(params_from_jax(tree), strict=True)
    return japi, jparams, tapi, model


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen2.5-3b"])
def test_prefill_and_decode_match_reference(arch):
    japi, jparams, tapi, model = _pair(arch)
    cfg = tapi.cfg
    assert cfg.tie_embeddings == (arch == "smollm-360m") and cfg.qkv_bias == (arch == "qwen2.5-3b")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    max_len = 32
    # full-sequence forward
    jax_forward = jax.jit(lambda p, t: jax_transformer.forward(p, japi.cfg, t))
    assert_close(transformer.forward(model, cfg, torch.from_numpy(tokens)),
                 jax_forward(jparams, jnp.asarray(tokens)), atol=LOGIT_ATOL, what="forward logits")
    # prefill: logits and the padded bf16 cache
    lt, ct = tapi.prefill(model, {"tokens": torch.from_numpy(tokens)}, max_len=max_len)
    lj, cj = jax.jit(lambda p, t: japi.prefill(p, {"tokens": t}, max_len=max_len))(
        jparams, jnp.asarray(tokens))
    assert lt.dtype == torch.float32 and lt.shape == (2, 16, cfg.padded_vocab)
    assert_close(lt, lj, atol=LOGIT_ATOL, what="prefill logits")
    for k in ("k", "v"):
        assert ct[k].dtype == torch.bfloat16 and ct[k].shape == tuple(cj[k].shape)
        assert_close(ct[k], cj[k], atol=1e-6, rtol=BF16_STEP, what=f"prefill cache {k}")
    np.testing.assert_array_equal(ct["lengths"].numpy(), np.asarray(cj["lengths"]))
    # 8 greedy decode steps: the port through make_serve_step, the reference
    # through its (jitted) decode and the same first-`vocab` argmax
    serve_t = make_serve_step(tapi, vocab=cfg.vocab_size)
    decode_j = jax.jit(japi.decode)
    nxt = np.argmax(np.asarray(lj)[:, -1, : cfg.vocab_size], axis=-1).astype(np.int32)[:, None]
    np.testing.assert_array_equal(lt[:, -1, : cfg.vocab_size].argmax(-1).numpy()[:, None], nxt)
    tok_t, tok_j = torch.from_numpy(nxt), jnp.asarray(nxt)
    for step in range(8):
        logits_t, _ = tapi.decode(model, {k: v.clone() for k, v in ct.items()}, tok_t)
        logits_j, cj = decode_j(jparams, cj, tok_j)
        assert_close(logits_t, logits_j, atol=LOGIT_ATOL, what=f"decode logits, step {step}")
        tok_t, ct = serve_t(model, ct, tok_t)
        tok_j = jnp.argmax(logits_j[:, -1, : cfg.vocab_size], axis=-1).astype(jnp.int32)[:, None]
        np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j), err_msg=f"step {step}")
    np.testing.assert_array_equal(ct["lengths"].numpy(), np.asarray(cj["lengths"]))
    assert int(ct["lengths"][0]) == 16 + 8


def test_decode_past_the_cache_end_drops_the_write():
    """JAX drops an out-of-range KV update; the port's in-place write does too."""
    tapi = get_model(get_config("smollm-360m").reduced())
    model = tapi.init(0, device="cpu")
    cache = tapi.init_cache(2, 4, device="cpu")
    cache["lengths"] = torch.tensor([3, 4], dtype=torch.int32)
    before = cache["k"][:, 1].clone()
    logits, new = tapi.decode(model, cache, torch.tensor([[1], [2]], dtype=torch.int32))
    assert torch.isfinite(logits).all()
    assert torch.equal(new["k"][:, 1], before)  # row 1 was full: nothing written
    assert not torch.equal(new["k"][:, 0, :, 3], torch.zeros_like(new["k"][:, 0, :, 3]))
    np.testing.assert_array_equal(new["lengths"].numpy(), [4, 5])


def test_cpu_attention_stays_the_eager_reference(monkeypatch):
    """On the CPU prefill and decode take common.attention_chunked and
    common.attention_decode, once per layer, and launch no kernel."""
    from repro_torch.kernels import flash_attention, paged_attention
    from repro_torch.models import common

    calls = {"attention_chunked": 0, "attention_decode": 0}
    for name in calls:
        orig = getattr(common, name)

        def counted(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(common, name, counted)
    before = (flash_attention.LAUNCHES["flash_attention"], paged_attention.LAUNCHES["paged_attention"])
    tapi = get_model(get_config("qwen2.5-3b").reduced())
    model = tapi.init(0, device="cpu")
    _, cache = tapi.prefill(model, {"tokens": torch.arange(12)[None]}, max_len=20)
    tapi.decode(model, cache, torch.tensor([[3]], dtype=torch.int32), page_size=4)
    n = tapi.cfg.n_layers
    assert calls == {"attention_chunked": n, "attention_decode": n}
    assert (flash_attention.LAUNCHES["flash_attention"],
            paged_attention.LAUNCHES["paged_attention"]) == before == (0, 0)
