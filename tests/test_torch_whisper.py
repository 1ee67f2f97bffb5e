"""The port's audio family (whisper-base, encoder-decoder) against the JAX
package's, on the CPU.

Reduced whisper-base (2 encoder and 2 decoder layers, d 64, 4/4 heads of
16, 16 audio frames), f32 compute, the reference's parameters carried over
by ``parity.params_from_jax`` (its stacked ``enc_layers`` and
``dec_layers`` split onto the port's layers), with seeded noise in the
LayerNorm weights and biases and the MLP biases (the reference
initialises them to ones and zeros):

1. ``gelu_mlp`` (the tanh GELU, ``jax.nn.gelu``'s default) and
   ``sinusoidal_positions`` against the reference's;
2. ``encode``; ``prefill``'s logits to 1e-4 and all four cache leaves
   (bf16 even at f32 compute) to one bf16 step; three decodes to 1e-4;
   a decode at bf16 compute against the reference's op by op (the stored
   f32 weights, uncast, as the reference's decode runs them);
   the ``active`` gate keeping an inactive row's every leaf bit for bit;
   a slot past ``max_len`` (its position row clamped as JAX clamps a
   gather); the held bf16 casts equal ``constrain_tree``'s leaf for leaf;
3. the engines, whole-slot and with ``prefill_chunk`` 8 (audio is not
   chunkable, so both prefill whole at admission): the JAX engine's
   per-step tokens and books, and the slot write carrying the cross caches.
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
from repro.models import whisper as jax_whisper  # noqa: E402
from repro.models.api import get_model as jax_model  # noqa: E402
from repro.runtime.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.runtime.serving import ServingEngine as JaxEngine  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.workloads import get_profile  # noqa: E402
from repro_torch.data.requests import RequestGenerator  # noqa: E402
from repro_torch.models import common, whisper  # noqa: E402
from repro_torch.models.api import get_model, kernel_launches  # noqa: E402
from repro_torch.parity import _tensor, assert_close, params_from_jax  # noqa: E402
from repro_torch.runtime.serving import EngineConfig, ServingEngine  # noqa: E402

ARCH = "whisper-base"
LOGIT_ATOL = 1e-4
BF16_STEP = 2.0 ** -7
CACHE_KEYS = ("k", "v", "cross_k", "cross_v")


def _noisy(tree, rng):
    """Seeded noise on every LayerNorm and MLP bias leaf (ones and zeros at
    init), so the norms' and biases' paths and casts are seen."""
    for stack in ("enc_layers", "dec_layers"):
        for name, sub in tree[stack].items():
            for leaf in [k for k in sub if k in ("w", "b", "b_in", "b_out")]:
                a = sub[leaf]
                sub[leaf] = (a + rng.standard_normal(a.shape) * 0.1).astype(a.dtype)
    for norm in ("enc_norm", "dec_norm"):
        for leaf, a in tree[norm].items():
            tree[norm][leaf] = (a + rng.standard_normal(a.shape) * 0.1).astype(a.dtype)
    return tree


@pytest.fixture(scope="module")
def pair():
    """(jax api, jax params, port api, port model) with identical weights."""
    jcfg = jax_config(ARCH).reduced()
    japi = jax_model(jcfg)
    tree = _noisy(jax.tree.map(np.asarray, japi.init(jax.random.PRNGKey(2))), np.random.default_rng(2))
    tapi = get_model(get_config(ARCH).reduced())
    model = tapi.init(0, device="cpu")
    model.load_state_dict(params_from_jax(tree), strict=True)
    assert tapi.family == "audio" and len(model.enc_layers) == 2 and len(model.dec_layers) == 2
    return japi, jax.tree.map(jnp.asarray, tree), tapi, model


def _inputs(cfg, b: int, s: int, seed: int):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    frames = rng.standard_normal((b, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return tokens, frames


def _decode_ref(japi, p, c, t):
    return jax.jit(japi.decode)(p, c, t)


@pytest.fixture(scope="module")
def prefilled(pair):
    """Both packages' prefill of 3 prompts of 10 over max_len 32."""
    japi, jparams, tapi, model = pair
    tokens, frames = _inputs(tapi.cfg, 3, 10, seed=0)
    lt, ct = tapi.prefill(model, {"tokens": torch.as_tensor(tokens), "frames": torch.as_tensor(frames)},
                          max_len=32)
    lj, cj = jax.jit(lambda p, t, f: japi.prefill(p, {"tokens": t, "frames": f}, max_len=32))(
        jparams, jnp.asarray(tokens), jnp.asarray(frames))
    return tokens, frames, (lt, ct), (lj, cj)


# ---------------------------------------------------------------------------
# 1. the primitives


def test_gelu_mlp_and_sinusoidal_positions_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    w_in, b_in = rng.standard_normal((32, 48)).astype(np.float32), rng.standard_normal(48).astype(np.float32)
    w_out, b_out = rng.standard_normal((48, 32)).astype(np.float32), rng.standard_normal(32).astype(np.float32)
    args = (x, w_in, b_in, w_out, b_out)
    got = common.gelu_mlp(*map(torch.as_tensor, args))
    assert_close(got, jax_common.gelu_mlp(*map(jnp.asarray, args)), atol=1e-5, rtol=1e-6, what="gelu_mlp")
    # the tanh approximation, not the erf form
    exact = torch.as_tensor(x) @ torch.as_tensor(w_in) + torch.as_tensor(b_in)
    exact = torch.nn.functional.gelu(exact) @ torch.as_tensor(w_out) + torch.as_tensor(b_out)
    assert (exact - got).abs().max() > 1e-5
    assert_close(common.sinusoidal_positions(16, 64), jax_common.sinusoidal_positions(16, 64),
                 atol=1e-6, rtol=1e-6, what="sinusoidal_positions(16, 64)")
    # at 1500 positions an angle p * div carries p times the last bit of
    # div, where the two frameworks' exp may round apart (div <= 1): the
    # tables then agree to 1500 * 2**-23
    assert_close(common.sinusoidal_positions(1500, 512), jax_common.sinusoidal_positions(1500, 512),
                 atol=1500 * 2.0 ** -23, what="sinusoidal_positions(1500, 512)")


# ---------------------------------------------------------------------------
# 2. the model


def test_encode_matches_reference(pair):
    japi, jparams, tapi, model = pair
    _, frames = _inputs(tapi.cfg, 2, 1, seed=1)
    got = whisper.encode(model, tapi.cfg, torch.as_tensor(frames))
    want = jax.jit(lambda p, f: jax_whisper.encode(p, japi.cfg, f))(jparams, jnp.asarray(frames))
    assert got.shape == (2, tapi.cfg.n_audio_frames, tapi.cfg.d_model)
    assert_close(got, want, atol=1e-5, what="encode")


def test_prefill_matches_reference(pair, prefilled):
    japi, jparams, tapi, model = pair
    tokens, frames, (lt, ct), (lj, cj) = prefilled
    cfg = tapi.cfg
    assert lt.dtype == torch.float32 and lt.shape == (3, 10, cfg.padded_vocab)
    assert_close(lt, lj, atol=LOGIT_ATOL, what="prefill logits")
    for k in CACHE_KEYS:
        assert ct[k].dtype == torch.bfloat16 and ct[k].shape == tuple(cj[k].shape), k
        assert_close(ct[k], cj[k], atol=1e-6, rtol=BF16_STEP, what=f"prefill cache {k}")
    assert ct["cross_k"].shape[3] == cfg.n_audio_frames and ct["k"].shape[3] == 32
    np.testing.assert_array_equal(ct["lengths"].numpy(), np.asarray(cj["lengths"]))
    # the teacher-forced forward gives the prefill's logits
    fwd = whisper.forward(model, cfg, torch.as_tensor(tokens), torch.as_tensor(frames))
    assert_close(fwd, lt, atol=1e-5, what="forward = prefill logits")


def test_three_decodes_match_reference(pair, prefilled):
    japi, jparams, tapi, model = pair
    _, _, _, (lj, cj) = prefilled
    cfg = tapi.cfg
    tok = np.argmax(np.asarray(lj)[:, -1, : cfg.vocab_size], axis=-1).astype(np.int32)[:, None]
    for step in range(3):
        ct = {k: _tensor(np.asarray(v)) for k, v in cj.items()}
        logits_t, ct = tapi.decode(model, ct, torch.from_numpy(tok))
        logits_j, cj = _decode_ref(japi, jparams, cj, jnp.asarray(tok))
        assert_close(logits_t, logits_j, atol=LOGIT_ATOL, what=f"decode logits, step {step}")
        for k in CACHE_KEYS:
            assert_close(ct[k], cj[k], atol=1e-6, rtol=BF16_STEP, what=f"decode cache {k}, step {step}")
        np.testing.assert_array_equal(ct["lengths"].numpy(), np.asarray(cj["lengths"]))
        tok = np.argmax(np.asarray(logits_j)[:, -1, : cfg.vocab_size], axis=-1).astype(np.int32)[:, None]
        assert (logits_t[:, -1, : cfg.vocab_size].argmax(-1).numpy()[:, None] == tok).all()


def test_bf16_decode_runs_the_stored_weights_as_the_reference(pair):
    """The reference's decode casts no weight (no ``constrain_tree``): at
    bf16 compute its bf16 activations meet the f32 weights, and the
    cross-attention's q comes out f32. The port's decode does the same, so
    from the reference's cache it gives the reference's logits, evaluated
    op by op, to 1e-5 (held bf16 casts there would miss by some 3e-3; XLA's
    compiled decode itself differs from its op-by-op evaluation by that
    much at bf16)."""
    japi, jparams, tapi, model = pair
    jcfg = dataclasses.replace(japi.cfg, compute_dtype="bfloat16")
    cfg = dataclasses.replace(tapi.cfg, compute_dtype="bfloat16")
    jbf, tbf = jax_model(jcfg), get_model(cfg)
    tokens, frames = _inputs(cfg, 2, 8, seed=5)
    _, cj = jax.jit(lambda p, t, f: jbf.prefill(p, {"tokens": t, "frames": f}, max_len=16))(
        jparams, jnp.asarray(tokens), jnp.asarray(frames))
    tok = np.array([[3], [4]], np.int32)
    with jax.disable_jit():
        want, _ = jbf.decode(jparams, cj, jnp.asarray(tok))
    got, _ = tbf.decode(model, {k: _tensor(np.asarray(v)) for k, v in cj.items()}, torch.from_numpy(tok))
    assert got.dtype == torch.float32
    assert_close(got, want, atol=1e-5, what="bf16 decode logits")


def test_active_gate_keeps_an_inactive_row(pair, prefilled):
    """A row where ``active`` is False keeps every leaf (self and cross K/V,
    length) bit for bit; the active rows get the ungated decode's logits
    and caches."""
    _, _, tapi, model = pair
    _, _, (_, ct), _ = prefilled
    tok = torch.tensor([[3], [5], [7]], dtype=torch.int32)
    before = {k: v.clone() for k, v in ct.items()}
    gated, out = tapi.decode(model, {k: v.clone() for k, v in ct.items()}, tok,
                             active=torch.tensor([True, False, True]))
    full, ref = tapi.decode(model, {k: v.clone() for k, v in ct.items()}, tok)
    for k in CACHE_KEYS:
        assert torch.equal(out[k][:, 1], before[k][:, 1]), k
        assert torch.equal(out[k][:, [0, 2]], ref[k][:, [0, 2]]), k
    assert out["lengths"].tolist() == [11, 10, 11]
    assert torch.equal(gated[[0, 2]], full[[0, 2]])
    assert not torch.equal(out["k"][:, 0], before["k"][:, 0])


def test_slot_past_max_len_matches_reference(pair):
    """An inactive slot keeps decoding past the cache's end in the engine:
    the write is dropped and the position row clamped, as JAX drops an
    out-of-range scatter and clamps an out-of-range gather."""
    japi, jparams, tapi, model = pair
    tokens, frames = _inputs(tapi.cfg, 2, 6, seed=4)
    lj, cj = jax.jit(lambda p, t, f: japi.prefill(p, {"tokens": t, "frames": f}, max_len=8))(
        jparams, jnp.asarray(tokens), jnp.asarray(frames))
    cj = dict(cj, lengths=jnp.asarray([8, 11], jnp.int32))  # both at or past the end (S = 8)
    tok = np.array([[1], [2]], np.int32)
    ct = {k: _tensor(np.asarray(v)) for k, v in cj.items()}
    before = {k: v.clone() for k, v in ct.items()}
    logits_t, ct = tapi.decode(model, ct, torch.from_numpy(tok))
    logits_j, cj2 = _decode_ref(japi, jparams, cj, jnp.asarray(tok))
    assert_close(logits_t, logits_j, atol=LOGIT_ATOL, what="decode past max_len")
    assert all(torch.equal(ct[k], before[k]) for k in CACHE_KEYS)
    np.testing.assert_array_equal(ct["lengths"].numpy(), [9, 12])
    np.testing.assert_array_equal(np.asarray(cj2["lengths"]), [9, 12])


def test_compute_casts_every_float_leaf_as_the_reference(pair):
    """At bf16 compute the reference's ``constrain_tree`` casts every float
    leaf of an encoder and a decoder layer (LayerNorm weights and biases
    and MLP biases included); the port's held casts give the same leaves
    bit for bit."""
    japi, jparams, tapi, model = pair

    def flat(tree, prefix=""):
        for k, v in tree.items():
            yield from flat(v, f"{prefix}{k}.") if isinstance(v, dict) else [(prefix + k, v)]

    for stack, specs in (("enc_layers", jax_whisper.enc_layer_specs),
                         ("dec_layers", jax_whisper.dec_layer_specs)):
        jl = jax.tree.map(lambda a: a[1], jparams[stack])
        want = dict(flat(jax_common.constrain_tree(jl, specs(japi.cfg), jnp.bfloat16)))
        got = dict(flat(getattr(model, stack)[1].tree(torch.bfloat16)))
        assert sorted(want) == sorted(got) and "ln1.b" in got and "mlp.b_in" in got, stack
        for name, leaf in got.items():
            assert leaf.dtype == torch.bfloat16, name
            assert_close(leaf, want[name], atol=0.0, what=f"{stack}.{name}")
        # held: the same tensors on a second call
        again = dict(flat(getattr(model, stack)[1].tree(torch.bfloat16)))
        assert all(again[n] is got[n] for n in got)


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
        out["engine", chunk] = eng
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
    eng = engines["engine", chunk]
    cfg = eng.cfg
    # the payload rows are the decoder self-attention's k and v vectors
    assert eng.tiered.row_dim == 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim
    assert eng.prefill_dispatches > 0 and eng.batch_decodes > 0
    # the chunk budget changes nothing for audio, on either package
    for pkg in ("jax", "port"):
        t0, l0, s0, r0, f0, _ = engines[pkg, 0]
        t1, l1, s1, r1, f1, _ = engines[pkg, chunk]
        np.testing.assert_array_equal(t1, t0)
        assert l1 == l0 and s1 == s0 and f1 == f0
        np.testing.assert_array_equal(r1, r0)
    # what the card would launch for this run's dispatches
    want = kernel_launches(cfg, eng.prefill_dispatches, eng.batch_decodes)
    assert want["flash_attention"] == (cfg.n_encoder_layers + 2 * cfg.n_layers) * eng.prefill_dispatches \
        + cfg.n_layers * eng.batch_decodes
    assert want["paged_attention"] == cfg.n_layers * eng.batch_decodes


def test_slot_write_carries_the_cross_caches(pair):
    """A whole-slot admission copies every leaf of the batch-1 prefill cache
    into its slot: the cross caches too, bit for bit."""
    _, _, tapi, model = pair
    eng = ServingEngine(tapi, model, EngineConfig(**_ekw()), seed=0, device="cpu")
    gen = RequestGenerator(_prof(get_profile), vocab_size=tapi.cfg.vocab_size, seed=3)
    reqs = [next(gen) for _ in range(2)]
    for r in reqs:
        eng.submit(r)
    eng._admit()
    batch = eng._prefill_batch(reqs[1].tokens[: eng.ecfg.max_len - 2])
    assert sorted(batch) == ["frames", "tokens"] and batch["frames"].dtype == torch.bfloat16
    assert batch["frames"].shape == (1, tapi.cfg.n_audio_frames, tapi.cfg.d_model) and not batch["frames"].any()
    _, cache1 = tapi.prefill(model, batch, max_len=eng.ecfg.max_len)
    for k in CACHE_KEYS:
        assert torch.equal(eng.cache[k][:, 1], cache1[k][:, 0]), k
    assert eng.cache["cross_k"][:, 1].abs().sum() > 0
    assert not eng.cache["cross_k"][:, 2:].any()
