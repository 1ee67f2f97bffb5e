"""The port's MoE family against the JAX package's, on the CPU.

Reduced granite-moe-3b (routed experts only) and qwen2-moe-a2.7b (with
the shared expert), f32 compute, the reference's parameters carried over
by ``parity.params_from_jax``:

1. routing: ``_route`` (expert ids bit-exact, renormalized weights to
   1e-6) and ``_capacity`` over a grid of group sizes; both dispatch
   backends to 1e-5 with their keep masks bit-exact, on inputs that
   overflow an expert's capacity;
2. the model: prefill logits to 1e-4 and the bf16 cache to one bf16 step,
   then 8 decode steps from the reference's cache to 1e-4 with equal greedy
   tokens;
3. the engines: the whole-slot and the chunked engine give the JAX
   engines' per-step tokens and books;
4. the traps: exact ties route the lower expert id first, as
   ``jax.lax.top_k``; and a decode routes the whole batch as one group, so
   an inactive low row still pushes a later active row past capacity, the
   same slot in both packages.
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
from repro.models import moe as jax_moe  # noqa: E402
from repro.models.api import get_model as jax_model  # noqa: E402
from repro.runtime.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.runtime.serving import ServingEngine as JaxEngine  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.workloads import get_profile  # noqa: E402
from repro_torch.data.requests import RequestGenerator  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.api import get_model, make_serve_step  # noqa: E402
from repro_torch.parity import _tensor, assert_close, params_from_jax  # noqa: E402
from repro_torch.runtime.serving import EngineConfig, ServingEngine  # noqa: E402

ARCHS = ["granite-moe-3b-a800m", "qwen2-moe-a2.7b"]
LOGIT_ATOL = 1e-4
FFN_ATOL = 1e-5
BF16_STEP = 2.0 ** -7
CHUNK = 8


def _carry(tree):
    tapi = get_model(get_config(tree["arch"]).reduced())
    model = tapi.init(0, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, tree["params"])), strict=True)
    return tapi, model


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(jax api, jax params, port api, port model) with identical weights."""
    cfg = jax_config(request.param).reduced()
    japi = jax_model(cfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    tapi, model = _carry({"arch": request.param, "params": jparams})
    assert tapi.cfg.family == "moe" and bool(tapi.cfg.n_shared_experts) == ("qwen2" in request.param)
    return japi, jparams, tapi, model


def _layer(jparams, model, i: int = 0):
    return (jax.tree.map(lambda a: a[i], jparams["layers"]), model.layers[i].tree(torch.float32))


def _skewed(cfg, g: int, t: int, seed: int) -> np.ndarray:
    """(g, t, d) inputs that all lean toward one direction, so a few experts
    take most slots and some overflow their capacity."""
    rng = np.random.default_rng(seed)
    lean = rng.standard_normal(cfg.d_model)
    return (rng.standard_normal((g, t, cfg.d_model)) + 2.0 * lean).astype(np.float32)


def _jax_keep(topi, c: int, e: int, backend: str) -> np.ndarray:
    """The reference's keep mask (G, T, k), as each backend forms it."""
    topi = jnp.asarray(topi)
    g, t, k = topi.shape
    if backend == "einsum":
        ohf = jax.nn.one_hot(topi, e, dtype=jnp.float32).reshape(g, t * k, e)
        pos = jnp.cumsum(ohf, axis=1) - ohf
        return np.asarray(jnp.sum(pos * ohf, axis=-1).reshape(g, t, k) < c)
    out = []
    for ti in np.asarray(topi):
        flat_e = jnp.asarray(ti.reshape(t * k))
        order = jnp.argsort(flat_e, stable=True)
        counts = jnp.bincount(flat_e, length=e)
        starts = jnp.cumsum(counts) - counts
        keep = jnp.arange(t * k) - starts[flat_e[order]] < c
        out.append(np.asarray(jnp.zeros(t * k, bool).at[order].set(keep)).reshape(t, k))
    return np.stack(out)


# ---------------------------------------------------------------------------
# 1. routing and dispatch


def test_route_and_capacity_match_reference(pair):
    japi, jparams, tapi, model = pair
    jl, tl = _layer(jparams, model)
    x = np.random.default_rng(0).standard_normal((3, 16, tapi.cfg.d_model)).astype(np.float32)
    tv, ti, tp = moe._route(tl["router"], tapi.cfg, torch.as_tensor(x))
    jv, ji, jp = jax_moe._route(jl["router"], japi.cfg, jnp.asarray(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert_close(tv, jv, atol=1e-6, what="topv")
    assert_close(tp, jp, atol=1e-6, what="probs")
    assert_close(moe.aux_losses(tp, ti, tapi.cfg), jax_moe.aux_losses(jp, ji, japi.cfg), atol=1e-7,
                 what="aux loss")
    for arch in ARCHS:
        for cfg, jcfg in ((get_config(arch), jax_config(arch)),
                          (get_config(arch).reduced(), jax_config(arch).reduced())):
            for t in list(range(0, 70)) + [255, 256, 511, 512, 1000, 1024, 2048, 4096, 32768]:
                assert moe._capacity(t, cfg) == jax_moe._capacity(t, jcfg), (arch, t)
    # the engines' shapes at granite-moe-3b's full width
    full = get_config("granite-moe-3b-a800m")
    assert (moe._capacity(8, full), moe._capacity(512, full)) == (4, 128)


@pytest.mark.parametrize("backend", ["einsum", "sort"])
def test_dispatch_backends_match_reference(pair, backend):
    """Each backend against the reference's on inputs that overflow: the
    outputs to 1e-5, the keep masks bit-exact, and the two backends keep
    the same slots."""
    japi, jparams, tapi, model = pair
    jl, tl = _layer(jparams, model, 1)
    cfg = tapi.cfg
    x = _skewed(cfg, 2, 48, seed=3)
    fn, jfn = {"einsum": (moe.moe_einsum, jax_moe.moe_einsum),
               "sort": (moe.moe_sort, jax_moe.moe_sort)}[backend]
    out, keep = fn(tl, cfg, torch.as_tensor(x))
    jout, _aux = jfn(jl, japi.cfg, jnp.asarray(x))
    assert_close(out, jout, atol=FFN_ATOL, what=f"{backend} output")
    _, ji, _ = jax_moe._route(jl["router"], japi.cfg, jnp.asarray(x))
    c = moe._capacity(48, cfg)
    want = _jax_keep(ji, c, cfg.n_experts, backend)
    np.testing.assert_array_equal(keep.numpy(), want)
    assert 0 < int((~keep).sum()) < keep.numel(), "no slot overflowed: the inputs test nothing"
    other = moe.moe_sort if backend == "einsum" else moe.moe_einsum
    o2, k2 = other(tl, cfg, torch.as_tensor(x))
    assert torch.equal(keep, k2)
    assert_close(o2, out, atol=FFN_ATOL, what="einsum vs sort")
    # the whole ffn, shared expert included, through either backend
    for disp in ("einsum", "sort"):
        y = moe.moe_ffn(tl, cfg, torch.as_tensor(x), disp)
        jy, _ = jax_moe.moe_ffn(jl, japi.cfg, jnp.asarray(x), disp)
        assert_close(y, jy, atol=FFN_ATOL, what=f"moe_ffn {disp}")


def test_long_sequences_regroup_as_the_reference():
    """The regroup rule is the reference's verbatim: a sequence longer than
    ``moe_group`` and a multiple of it routes in groups of ``moe_group``
    (capacity per group), anything else as one group."""
    jcfg = dataclasses.replace(jax_config("granite-moe-3b-a800m").reduced(), moe_group=16)
    japi = jax_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(2))
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m").reduced(), moe_group=16)
    model = get_model(cfg).init(0, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)), strict=True)
    jl, tl = _layer(jparams, model)
    for t in (16, 24, 32, 48):
        x = _skewed(cfg, 1, t, seed=t)
        y = moe.moe_ffn(tl, cfg, torch.as_tensor(x))
        jy, _ = jax_moe.moe_ffn(jl, jcfg, jnp.asarray(x))
        assert_close(y, jy, atol=FFN_ATOL, what=f"moe_ffn t={t}")
    # grouped (32 = 2 x 16) differs from one group of 32: the rule bit
    x = _skewed(cfg, 1, 32, seed=32)
    grouped = moe.moe_ffn(tl, cfg, torch.as_tensor(x))
    whole = moe.moe_ffn(tl, dataclasses.replace(cfg, moe_group=0), torch.as_tensor(x))
    assert not torch.allclose(grouped, whole, atol=1e-3)


def test_compute_casts_every_float_leaf_as_the_reference(pair):
    """At bf16 compute the reference's ``constrain_tree`` casts every float
    leaf of a layer, the f32-initialised router and the shared expert's gate
    included; the port's held casts give the same leaves, bit for bit (a
    router held in f32 would route differently)."""
    japi, jparams, tapi, model = pair
    jl = jax.tree.map(lambda a: a[0], jparams["layers"])
    want = jax_common.constrain_tree(jl, jax_moe.layer_specs(japi.cfg), jnp.bfloat16)
    got = model.layers[0].tree(torch.bfloat16)

    def flat(tree, prefix=""):
        for k, v in tree.items():
            yield from flat(v, f"{prefix}{k}.") if isinstance(v, dict) else [(prefix + k, v)]

    want, got = dict(flat(want)), dict(flat(got))
    assert sorted(want) == sorted(got) and "router" in got
    assert ("shared.gate" in got) == bool(tapi.cfg.n_shared_experts)
    for name, leaf in got.items():
        assert leaf.dtype == torch.bfloat16, name
        assert_close(leaf, want[name], atol=0.0, what=name)


# ---------------------------------------------------------------------------
# 2. the model


def test_prefill_and_decode_match_reference(pair):
    japi, jparams, tapi, model = pair
    cfg = tapi.cfg
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 20)).astype(np.int32)
    max_len = 32
    lt, ct = tapi.prefill(model, {"tokens": torch.from_numpy(tokens)}, max_len=max_len)
    lj, cj = jax.jit(lambda p, t: japi.prefill(p, {"tokens": t}, max_len=max_len))(
        jparams, jnp.asarray(tokens))
    assert lt.dtype == torch.float32 and lt.shape == (3, 20, cfg.padded_vocab)
    assert_close(lt, lj, atol=LOGIT_ATOL, what="prefill logits")
    for k in ("k", "v"):
        assert ct[k].dtype == torch.bfloat16 and ct[k].shape == tuple(cj[k].shape)
        assert_close(ct[k], cj[k], atol=1e-6, rtol=BF16_STEP, what=f"prefill cache {k}")
    # decode from the reference's cache (a value near a bf16 rounding
    # boundary may round the other way in the port's own prefill)
    serve_t = make_serve_step(tapi, vocab=cfg.vocab_size)
    decode_j = jax.jit(japi.decode)
    tok = np.argmax(np.asarray(lj)[:, -1, : cfg.vocab_size], axis=-1).astype(np.int32)[:, None]
    for step in range(8):
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


@pytest.mark.parametrize("chunk", [0, CHUNK], ids=["whole_slot", "chunked"])
def test_engine_matches_reference(pair, chunk):
    japi, jparams, tapi, model = pair
    jeng = JaxEngine(japi, jparams, JaxEngineConfig(**_ekw(prefill_chunk=chunk)), seed=0)
    jtok = _run(jeng, JaxGenerator(_prof(jax_profile), vocab_size=japi.cfg.vocab_size, seed=0))
    eng = ServingEngine(tapi, model, EngineConfig(**_ekw(prefill_chunk=chunk, tiered_verify=True)),
                        seed=0, device="cpu")
    assert eng.chunking == jeng.chunking == bool(chunk)
    tok = _run(eng, RequestGenerator(_prof(get_profile), vocab_size=tapi.cfg.vocab_size, seed=0))
    np.testing.assert_array_equal(tok, jtok)
    assert eng.live_counters() == jeng.live_counters()
    st = eng.stats()
    assert st == jeng.stats()
    np.testing.assert_array_equal(eng.role_hits, jeng.role_hits)
    assert eng.ttft_vt_samples == jeng.ttft_vt_samples
    dev = st["device_tiering"]
    assert dev["max_read_error"] == 0.0 and dev["dispatches_per_step"] == 1.0
    assert dev["near_hits"] > 0 and dev["far_hits"] > 0
    # the tier store's payload rows are the moe layers' k and v vectors
    assert eng.tiered.row_dim == 2 * tapi.cfg.n_layers * tapi.cfg.n_kv_heads * tapi.cfg.head_dim
    assert (st["serving"]["prefill_dispatches"] == 0) == bool(chunk)


# ---------------------------------------------------------------------------
# 4. the traps


def test_ties_route_the_lower_expert_first(pair):
    """Probabilities with exact ties: a zero router (all E tie) and a router
    whose columns come in equal pairs (each pair ties, so the top-k
    boundary falls inside a tied pair). ``torch.topk`` promises no order
    among ties; the port's ids are the reference's bit for bit."""
    japi, jparams, tapi, model = pair
    cfg = tapi.cfg
    d, e, k = cfg.d_model, cfg.n_experts, cfg.top_k
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, d)).astype(np.float32)
    half = rng.standard_normal((d, e // 2)).astype(np.float32)
    for router in (np.zeros((d, e), np.float32), np.repeat(half, 2, axis=1)):
        _, ti, tp = moe._route(torch.as_tensor(router), cfg, torch.as_tensor(x))
        _, ji, _ = jax_moe._route(jnp.asarray(router), japi.cfg, jnp.asarray(x))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        top = tp.gather(-1, ti)
        assert bool((top[..., :-1] == top[..., 1:]).any()), "no tie inside the top k"
    # every probability equal: the first k experts, in order
    _, ti, _ = moe._route(torch.zeros((d, e)), cfg, torch.as_tensor(x))
    assert (ti.numpy() == np.arange(k)).all()


def _coupled_router(model, cfg, seed: int = 7):
    """Every layer's router: expert 0 leans one way (+u), expert 1 the other
    (-u), the rest 0. Each token's first choice is 0 or 1, and its second
    is expert 2 (the lowest of the tied zeros), so every row queues on
    expert 2 and a batch of more than its capacity overflows it."""
    u = (np.random.default_rng(seed).standard_normal(cfg.d_model) / np.sqrt(cfg.d_model)).astype(np.float32)
    r = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    r[:, 0], r[:, 1] = u, -u
    state = {f"layers.{i}.router": torch.as_tensor(r) for i in range(cfg.n_layers)}
    model.load_state_dict(state, strict=False)
    return r


def test_inactive_row_still_takes_its_capacity_slot(pair):
    """A decode routes the whole batch as one group. With row 0 inactive
    (the gate keeps its cache) it still holds its place in expert 2's queue,
    so row 4, the first past capacity 4, drops its second expert: the same
    slot drops in the port and the reference, the logits of every row agree,
    and without row 0 in the group row 4 would have kept it."""
    japi, jparams, tapi, model = pair
    cfg = tapi.cfg
    _, model = _carry({"arch": cfg.name, "params": jparams})
    router = _coupled_router(model, cfg)
    tree = jax.tree.map(np.asarray, jparams)
    tree["layers"]["router"] = np.broadcast_to(router, tree["layers"]["router"].shape).copy()
    jparams = jax.tree.map(jnp.asarray, tree)
    b = 8
    assert moe._capacity(b, cfg) == 4
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, cfg.vocab_size, (b, 12)).astype(np.int32)
    _, cj = japi.prefill(jparams, {"tokens": jnp.asarray(prompt)}, max_len=32)
    tok = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    # the keep masks of the first moe layer, on the first layer's inputs
    jl, tl = _layer(jparams, model)
    x = _skewed(cfg, 1, b, seed=9)
    _, keep = moe.moe_einsum(tl, cfg, torch.as_tensor(x))
    _, ji, _ = jax_moe._route(jl["router"], japi.cfg, jnp.asarray(x))
    np.testing.assert_array_equal(keep.numpy(), _jax_keep(ji, 4, cfg.n_experts, "einsum"))
    assert keep[0, :4].all() and not keep[0, 4:, 1].any(), keep
    _, keep7 = moe.moe_einsum(tl, cfg, torch.as_tensor(x[:, 1:]))
    assert bool(keep7[0, 3].all()), "row 4 keeps both experts when row 0 is not in the group"
    # a gated decode against the reference's ungated one (its chunk column
    # gates after the step)
    active = torch.tensor([False] + [True] * (b - 1))
    cache = {k: _tensor(np.asarray(v)) for k, v in cj.items()}
    before = {k: v.clone() for k, v in cache.items()}
    logits_t, out = tapi.decode(model, cache, torch.from_numpy(tok), active=active)
    logits_j, cj2 = japi.decode(jparams, cj, jnp.asarray(tok))
    assert_close(logits_t, logits_j, atol=LOGIT_ATOL, what="gated decode logits")
    for k in ("k", "v"):
        assert torch.equal(out[k][:, 0], before[k][:, 0])
        assert_close(out[k][:, 1:], np.asarray(cj2[k])[:, 1:], atol=1e-6, rtol=BF16_STEP, what=k)
    assert out["lengths"].tolist() == [12] + [13] * (b - 1)
    # row 0 out of the group changes row 4's logits: the coupling is real
    short = {k: _tensor(np.asarray(v))[:, 1:] if v.ndim > 1 else _tensor(np.asarray(v))[1:]
             for k, v in cj.items()}
    logits_7, _ = tapi.decode(model, short, torch.from_numpy(tok[1:]))
    assert (logits_7[3] - logits_t[4]).abs().max() > 1e-3
    assert_close(logits_7[:3], logits_t[1:4], atol=LOGIT_ATOL, what="rows before the overflow")

