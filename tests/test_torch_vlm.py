"""The port's vlm family (qwen2-vl-7b's text backbone, M-RoPE) against the
JAX package's, on the CPU.

Reduced qwen2-vl-7b (2 layers, d 64, 4/4 heads of 16, M-RoPE sections
(4, 2, 2)), f32 compute, the reference's parameters carried over by
``parity.params_from_jax`` with seeded noise in the qkv biases (the
reference initialises them to zero):

1. ``apply_mrope`` against the reference's on random 3-D positions (1e-6),
   and with three equal channels bit-equal to ``apply_rope``, at the
   reduced and the full head_dim;
2. a prefill from embeddings with image-grid M-RoPE positions (an image
   block at one t over an h x w grid, then text): logits to 1e-4, the bf16
   cache to one bf16 step; then two decodes (1-D RoPE at ``lengths``)
   against the reference evaluated op by op, to 1e-4; and a decode at
   3-D M-RoPE positions against the reference's ``decode_step`` at them;
3. the engines, whole-slot and with ``prefill_chunk`` 8 (vlm is not
   chunkable, so both prefill whole at admission): the JAX engine's
   per-step tokens and books, and the chunk budget gives the whole-slot
   books on both packages.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs.workloads import get_profile as jax_profile  # noqa: E402
from repro.data.requests import RequestGenerator as JaxGenerator  # noqa: E402
from repro.models import common as jax_common  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.models.api import get_model as jax_model  # noqa: E402
from repro.runtime.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.runtime.serving import ServingEngine as JaxEngine  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.workloads import get_profile  # noqa: E402
from repro_torch.data.requests import RequestGenerator  # noqa: E402
from repro_torch.models import common, transformer  # noqa: E402
from repro_torch.models.api import get_model, make_serve_step  # noqa: E402
from repro_torch.parity import _tensor, assert_close, params_from_jax  # noqa: E402
from repro_torch.runtime.serving import EngineConfig, ServingEngine  # noqa: E402

ARCH = "qwen2-vl-7b"
LOGIT_ATOL = 1e-4
BF16_STEP = 2.0 ** -7


@pytest.fixture(scope="module")
def pair():
    """(jax api, jax params, port api, port model) with identical weights."""
    jcfg = jax_config(ARCH).reduced()
    japi = jax_model(jcfg)
    tree = jax.tree.map(np.asarray, japi.init(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(1)
    for b in ("bq", "bk", "bv"):
        leaf = tree["layers"]["attn"][b]
        tree["layers"]["attn"][b] = (rng.standard_normal(leaf.shape) * 0.1).astype(leaf.dtype)
    tapi = get_model(get_config(ARCH).reduced())
    model = tapi.init(0, device="cpu")
    model.load_state_dict(params_from_jax(tree), strict=True)
    assert tapi.family == "vlm" and tapi.cfg.qkv_bias and not tapi.cfg.tie_embeddings
    return japi, jax.tree.map(jnp.asarray, tree), tapi, model


def image_grid_positions(batch: int, n_text_before: int, grid: tuple, n_text_after: int) -> np.ndarray:
    """(3, B, L) M-RoPE ids as Qwen2-VL lays out an image: text at t = h =
    w = its index, then the image's patches at one t over an h x w grid
    (each offset by the text before), then text again, all three channels
    resuming past the largest id so far."""
    gh, gw = grid
    t = list(range(n_text_before))
    pos = [t[:], t[:], t[:]]
    base = n_text_before
    for i in range(gh):
        for j in range(gw):
            pos[0].append(base)
            pos[1].append(base + i)
            pos[2].append(base + j)
    nxt = base + max(gh, gw)
    for c in range(3):
        pos[c] += list(range(nxt, nxt + n_text_after))
    return np.broadcast_to(np.asarray(pos, np.int32)[:, None, :], (3, batch, len(pos[0]))).copy()


# ---------------------------------------------------------------------------
# 1. M-RoPE


@pytest.mark.parametrize("hd,sections", [(16, (4, 2, 2)), (128, (16, 24, 24))])
def test_apply_mrope_matches_reference(hd, sections):
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 3, 12, hd)).astype(np.float32)
    pos = rng.integers(0, 4096, (3, 2, 12)).astype(np.int32)
    got = common.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos), 1e6, sections)
    want = jax_common.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    assert_close(got, want, atol=1e-6, rtol=1e-6, what="apply_mrope")
    # the channels matter: the t, h and w positions each move their section
    same = common.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos[[0, 0, 0]]), 1e6, sections)
    assert not torch.equal(same, got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,sections", [(16, (4, 2, 2)), (128, (16, 24, 24))])
def test_equal_channels_are_rope_bit_for_bit(hd, sections, dtype):
    rng = np.random.default_rng(7)
    x = torch.as_tensor(rng.standard_normal((2, 4, 9, hd)).astype(np.float32)).to(dtype)
    pos = torch.as_tensor(rng.integers(0, 100000, (2, 9)).astype(np.int32))
    got = common.apply_mrope(x, pos[None].expand(3, 2, 9), 1e6, sections)
    assert got.dtype == dtype and torch.equal(got, common.apply_rope(x, pos, 1e6))


# ---------------------------------------------------------------------------
# 2. the model


def test_prefill_with_image_grid_positions_then_decode(pair):
    japi, jparams, tapi, model = pair
    cfg = tapi.cfg
    rng = np.random.default_rng(0)
    pos = image_grid_positions(2, 3, (3, 4), 5)  # 3 text, 12 patches, 5 text
    n = pos.shape[-1]
    emb = rng.standard_normal((2, n, cfg.d_model)).astype(np.float32)
    max_len = 32
    batch_t = {"embeds": torch.as_tensor(emb), "mrope_positions": torch.as_tensor(pos)}
    lt, ct = tapi.prefill(model, batch_t, max_len=max_len)
    lj, cj = jax.jit(lambda p, e, m: japi.prefill(p, {"embeds": e, "mrope_positions": m}, max_len=max_len))(
        jparams, jnp.asarray(emb), jnp.asarray(pos))
    assert lt.dtype == torch.float32 and lt.shape == (2, n, cfg.padded_vocab)
    assert_close(lt, lj, atol=LOGIT_ATOL, what="prefill logits")
    for k in ("k", "v"):
        assert ct[k].dtype == torch.bfloat16 and ct[k].shape == tuple(cj[k].shape)
        assert_close(ct[k], cj[k], atol=1e-6, rtol=BF16_STEP, what=f"prefill cache {k}")
    np.testing.assert_array_equal(ct["lengths"].numpy(), np.asarray(cj["lengths"]))
    # the grid is seen: 1-D positions give other logits
    flat = transformer.forward(model, cfg, embeds=batch_t["embeds"])
    assert (flat - lt).abs().max() > 1e-3
    assert_close(transformer.forward(model, cfg, **batch_t), lt, atol=1e-5, what="forward = prefill logits")
    # two decodes from the reference's cache, text continuing at lengths;
    # the reference evaluated op by op: at these inputs its XLA-compiled
    # decode differs from that by up to 1.3e-4 itself (the port agrees with
    # the op-by-op evaluation to some 2e-6)
    serve_t = make_serve_step(tapi, vocab=cfg.vocab_size)

    def decode_j(p, c, t):
        with jax.disable_jit():
            return japi.decode(p, c, t)

    tok = np.argmax(np.asarray(lj)[:, -1, : cfg.vocab_size], axis=-1).astype(np.int32)[:, None]
    for step in range(2):
        ct = {k: _tensor(np.asarray(v)) for k, v in cj.items()}
        logits_t, _ = tapi.decode(model, {k: v.clone() for k, v in ct.items()}, torch.from_numpy(tok))
        nxt_t, ct = serve_t(model, ct, torch.from_numpy(tok))
        logits_j, cj = decode_j(jparams, cj, jnp.asarray(tok))
        assert_close(logits_t, logits_j, atol=LOGIT_ATOL, what=f"decode logits, step {step}")
        tok = np.argmax(np.asarray(logits_j)[:, -1, : cfg.vocab_size], axis=-1).astype(np.int32)[:, None]
        np.testing.assert_array_equal(nxt_t.numpy(), tok, err_msg=f"step {step}")
        for k in ("k", "v"):
            assert_close(ct[k], cj[k], atol=1e-6, rtol=BF16_STEP, what=f"decode cache {k}")
        np.testing.assert_array_equal(ct["lengths"].numpy(), np.asarray(cj["lengths"]))


def test_decode_at_mrope_positions_matches_reference(pair):
    """A decode given (3, B, 1) M-RoPE positions, channels apart, after an
    image-grid prefill: logits to 1e-4 and the cache to one bf16 step of
    the reference's ``decode_step`` at the same positions (op by op); the
    positions are seen, and three equal channels at ``lengths`` give the
    1-D decode bit for bit."""
    japi, jparams, tapi, model = pair
    cfg = tapi.cfg
    rng = np.random.default_rng(5)
    pos = image_grid_positions(2, 3, (3, 4), 5)
    emb = rng.standard_normal((2, pos.shape[-1], cfg.d_model)).astype(np.float32)
    _, cj = jax.jit(lambda p, e, m: japi.prefill(p, {"embeds": e, "mrope_positions": m}, max_len=32))(
        jparams, jnp.asarray(emb), jnp.asarray(pos))
    tok = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    step_pos = np.broadcast_to(np.array([8, 11, 13], np.int32)[:, None, None], (3, 2, 1)).copy()
    ct = {k: _tensor(np.asarray(v)) for k, v in cj.items()}
    fresh = lambda: {k: v.clone() for k, v in ct.items()}
    got, gc = transformer.decode_step(model, cfg, fresh(), torch.from_numpy(tok), torch.from_numpy(step_pos))
    with jax.disable_jit():
        want, wc = jax_transformer.decode_step(jparams, japi.cfg, cj, jnp.asarray(tok), jnp.asarray(step_pos))
    assert_close(got, want, atol=LOGIT_ATOL, what="decode logits at M-RoPE positions")
    for k in ("k", "v"):
        assert_close(gc[k], wc[k], atol=1e-6, rtol=BF16_STEP, what=f"decode cache {k}")
    flat, fc = transformer.decode_step(model, cfg, fresh(), torch.from_numpy(tok))
    assert (flat - got).abs().max() > 1e-3
    at_lengths = ct["lengths"][None, :, None].expand(3, 2, 1)
    same, sc = transformer.decode_step(model, cfg, fresh(), torch.from_numpy(tok), at_lengths)
    assert torch.equal(same, flat) and all(torch.equal(sc[k], fc[k]) for k in fc)


def test_embeds_with_text_positions_are_the_token_path(pair):
    """The engine's prefill input (the embedding rows, three equal channels
    at the text positions) gives the token path's logits and cache bit for
    bit."""
    _, _, tapi, model = pair
    rng = np.random.default_rng(3)
    tokens = torch.as_tensor(rng.integers(0, tapi.cfg.vocab_size, (1, 11)), dtype=torch.int32)
    pos = torch.arange(11, dtype=torch.int32).expand(3, 1, 11)
    le, ce = tapi.prefill(model, {"embeds": model.embed[tokens.long()], "mrope_positions": pos}, max_len=16)
    lt, ctok = transformer.prefill(model, tapi.cfg, tokens, max_len=16)
    assert torch.equal(le, lt) and all(torch.equal(ce[k], ctok[k]) for k in ce)


# ---------------------------------------------------------------------------
# 3. the engines


def _ekw(**over):
    kw = dict(max_batch=4, max_len=64, n_pages=256, near_frac=0.02, placement_window=4,
              device_tiering=True, tiered_identity_scales=True)
    kw.update(over)
    return kw


def _prof(get):
    return dataclasses.replace(get("Web1"), prompt_mean=24, decode_mean=8, prefix_share=0.5,
                               n_prefixes=2)


def _run(eng, gen, n_requests: int = 6):
    for _ in range(n_requests):
        eng.submit(next(gen))
    tokens = []
    while (eng.queue or any(s.active for s in eng.slots)) and eng.engine_steps < 400:
        eng.step()
        tokens.append(np.asarray(eng.next_tokens).copy())
    return np.array(tokens)


@pytest.fixture(scope="module")
def engines(pair):
    """Each package's engine at prefill_chunk 0 and 8: (tokens, live
    counters, stats, role hits, TTFT samples, chunking)."""
    japi, jparams, tapi, model = pair
    out = {}
    for chunk in (0, 8):
        jeng = JaxEngine(japi, jparams, JaxEngineConfig(**_ekw(prefill_chunk=chunk)), seed=0)
        jtok = _run(jeng, JaxGenerator(_prof(jax_profile), vocab_size=japi.cfg.vocab_size, seed=0))
        eng = ServingEngine(tapi, model, EngineConfig(**_ekw(prefill_chunk=chunk, tiered_verify=True)),
                            seed=0, device="cpu")
        tok = _run(eng, RequestGenerator(_prof(get_profile), vocab_size=tapi.cfg.vocab_size, seed=0))
        for name, e, t in (("jax", jeng, jtok), ("port", eng, tok)):
            out[name, chunk] = (t, e.live_counters(), e.stats(), np.asarray(e.role_hits),
                                list(e.ttft_vt_samples), e.chunking)
    return out


@pytest.mark.parametrize("chunk", [0, 8], ids=["whole_slot", "prefill_chunk_8"])
def test_engine_matches_reference(engines, chunk):
    tok, live, st, role, ttft, chunking = engines["port", chunk]
    jtok, jlive, jst, jrole, jttft, jchunking = engines["jax", chunk]
    assert chunking is False and jchunking is False
    np.testing.assert_array_equal(tok, jtok)
    assert live == jlive and st == jst and ttft == jttft
    np.testing.assert_array_equal(role, jrole)
    dev = st["device_tiering"]
    assert dev["max_read_error"] == 0.0 and dev["dispatches_per_step"] == 1.0
    assert dev["near_hits"] > 0 and dev["far_hits"] > 0
    assert st["serving"]["prefill_dispatches"] > 0
    # the chunk budget changes nothing for vlm, on either package
    for pkg in ("jax", "port"):
        t0, l0, s0, r0, f0, _ = engines[pkg, 0]
        t1, l1, s1, r1, f1, _ = engines[pkg, chunk]
        np.testing.assert_array_equal(t1, t0)
        assert l1 == l0 and s1 == s0 and f1 == f0
        np.testing.assert_array_equal(r1, r0)


def test_prefill_batch_is_the_reference_layout(pair):
    _, _, tapi, model = pair
    eng = ServingEngine(tapi, model, EngineConfig(**_ekw()), seed=0, device="cpu")
    toks = np.array([5, 9, 2, 7], np.int32)
    batch = eng._prefill_batch(toks)
    assert sorted(batch) == ["embeds", "mrope_positions"]
    assert batch["embeds"].dtype == torch.float32 and torch.equal(batch["embeds"][0], model.embed[toks])
    assert batch["mrope_positions"].shape == (3, 1, 4)
    assert (batch["mrope_positions"] == torch.arange(4, dtype=torch.int32)).all()
