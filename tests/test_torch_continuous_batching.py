"""The port's continuous batching with chunked prefill, on the CPU.

1. Against the JAX package's chunked engine on reduced smollm-360m (dense),
   rwkv6-7b (ssm) and zamba2-1.2b (hybrid), with the reference's weights
   carried over by ``parity.params_from_jax``: the per-step next tokens,
   ``live_counters()``, the whole ``stats()`` book (role hits, model and
   prefill dispatches), the role plane and the TTFT samples are equal.
2. The contracts of ``tests/test_continuous_batching.py`` on the port:
   chunk budget infinity is the whole-slot engine, chunked tokens equal
   whole-slot tokens, the chunk boundaries over ten prompt lengths, slot
   reuse after early completion, the TTFT histogram's percentiles.
3. The chunked cases of ``tests/test_dispatch_budget.py``: one model
   dispatch and one tiered dispatch a step, and drain-cadence equivalence.
4. The gate: a decode column in which a row is inactive leaves every cache
   leaf of that row bit-unchanged, on all three families, and the active
   rows get what an ungated decode gives them.
"""
import dataclasses
from collections import defaultdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs.workloads import get_profile as jax_profile  # noqa: E402
from repro.data.requests import RequestGenerator as JaxGenerator  # noqa: E402
from repro.models.api import get_model as jax_model  # noqa: E402
from repro.runtime.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.runtime.serving import ServingEngine as JaxEngine  # noqa: E402

import repro_torch.runtime.tiered_kv as tiered_kv_mod  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.workloads import get_profile  # noqa: E402
from repro_torch.data.requests import Request, RequestGenerator  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.parity import params_from_jax  # noqa: E402
from repro_torch.runtime.serving import EngineConfig, ServingEngine  # noqa: E402

ARCHS = ["smollm-360m", "rwkv6-7b", "zamba2-1.2b"]
N_REQUESTS = 6
CHUNK = 8


def _ekw(**over):
    kw = dict(max_batch=4, max_len=64, n_pages=256, near_frac=0.02, placement_window=4,
              device_tiering=True, tiered_identity_scales=True)
    kw.update(over)
    return kw


def _prof(get):
    return dataclasses.replace(get("Web1"), prompt_mean=24, decode_mean=8,
                               prefix_share=0.5, n_prefixes=2)


def _run(eng, gen, n_requests=N_REQUESTS):
    for _ in range(n_requests):
        eng.submit(next(gen))
    tokens = []
    while (eng.queue or any(s.active for s in eng.slots)) and eng.engine_steps < 400:
        eng.step()
        tokens.append(np.asarray(eng.next_tokens).copy())
    return np.array(tokens)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """The JAX chunked engine's run, and the port's api and model holding
    the same parameters."""
    arch = request.param
    cfg = jax_config(arch).reduced()
    api = jax_model(cfg)
    params = api.init(jax.random.PRNGKey(0))
    eng = JaxEngine(api, params, JaxEngineConfig(**_ekw(prefill_chunk=CHUNK)), seed=0)
    assert eng.chunking
    tokens = _run(eng, JaxGenerator(_prof(jax_profile), vocab_size=cfg.vocab_size, seed=0))
    tapi = get_model(get_config(arch).reduced())
    model = tapi.init(0, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    ref = {
        "tokens": tokens,
        "live": eng.live_counters(),
        "stats": eng.stats(),
        "role_hits": eng.role_hits.copy(),
        "ttft": list(eng.ttft_vt_samples),
        "tier": eng.placement.tier.copy(),
    }
    return ref, tapi, model


def test_chunked_engine_matches_reference(pair):
    ref, tapi, model = pair
    eng = ServingEngine(tapi, model, EngineConfig(**_ekw(prefill_chunk=CHUNK, tiered_verify=True)),
                        seed=0, device="cpu")
    assert eng.chunking
    gen = RequestGenerator(_prof(get_profile), vocab_size=tapi.cfg.vocab_size, seed=0)
    tokens = _run(eng, gen)
    np.testing.assert_array_equal(tokens, ref["tokens"])
    assert eng.live_counters() == ref["live"]
    st = eng.stats()
    assert st == ref["stats"]
    np.testing.assert_array_equal(eng.role_hits, ref["role_hits"])
    assert eng.ttft_vt_samples == ref["ttft"]
    np.testing.assert_array_equal(eng.placement.tier, ref["tier"])
    dev, sv = st["device_tiering"], st["serving"]
    assert dev["max_read_error"] == 0.0 and dev["dispatches_per_step"] == 1.0
    assert dev["prefill_near_hits"] + dev["prefill_far_hits"] > 0
    assert sv["prefill_dispatches"] == 0 and sv["model_dispatches"] == eng.engine_steps
    # the chunk steps ran no more columns than the budget, and at least the
    # prompts' tokens spread over the four slots
    assert 0 < eng.chunk_columns <= CHUNK * eng.engine_steps
    assert eng.chunk_columns * 4 >= st["prefill_tokens"]


# ---------------------------------------------------------------------------
# the contracts of tests/test_continuous_batching.py, on the port


@pytest.fixture(scope="module")
def smollm():
    api = get_model(get_config("smollm-360m").reduced())
    return api, api.init(0, device="cpu")


def _mk(smollm, **over):
    api, model = smollm
    return ServingEngine(api, model, EngineConfig(**_ekw(**over)), seed=0, device="cpu")


def _gen(smollm, seed=0):
    return RequestGenerator(_prof(get_profile), vocab_size=smollm[0].cfg.vocab_size, seed=seed)


def _run_streams(eng, reqs, max_steps=300):
    """Each request's produced tokens. The slot -> seq map is taken right
    after ``_admit`` (retirement clears it before the step returns) and the
    next tokens after the step; a mid-prefill step produces no token for
    its slot, and the prompt-completing chunk step gives the request's
    first token (which the whole-slot path consumes inside its admit step,
    so a whole-slot stream starts at the second)."""
    for r in reqs:
        eng.submit(r)
    snap = {}
    orig_admit = eng._admit

    def admit_and_snapshot():
        orig_admit()
        snap.clear()
        snap.update({i: s.seq_id for i, s in enumerate(eng.slots) if s.active})

    eng._admit = admit_and_snapshot
    streams = defaultdict(list)
    steps = 0
    while (eng.queue or any(s.active for s in eng.slots)) and steps < max_steps:
        eng.step()
        nt = np.asarray(eng.next_tokens)
        for i, sid in snap.items():
            s = eng.slots[i]
            if s.active and s.seq_id == sid and s.prefilling:
                continue
            streams[sid].append(int(nt[i]))
        steps += 1
    assert not eng.queue and not any(s.active for s in eng.slots), "run truncated"
    return dict(streams)


def _first_token(eng, tokens):
    """The whole-slot admit's argmax for ``tokens``."""
    t = tokens[: max(1, eng.ecfg.max_len - 2)]
    logits, _ = eng.api.prefill(eng.params, {"tokens": torch.as_tensor(t)[None]},
                                max_len=eng.ecfg.max_len)
    return int(torch.argmax(logits[0, -1, : eng.cfg.vocab_size]))


def test_infinite_budget_is_whole_slot_bit_exact(smollm):
    runs = []
    for over in ({}, {"prefill_chunk": 0}):
        eng = _mk(smollm, **over)
        assert not eng.chunking
        gen = _gen(smollm, seed=7)
        streams = _run_streams(eng, [next(gen) for _ in range(8)])
        runs.append((streams, eng.live_counters(), eng.stats()))
    (st_a, lc_a, s_a), (st_b, lc_b, s_b) = runs
    assert st_a == st_b and lc_a == lc_b and s_a == s_b
    assert s_a["serving"]["prefill_dispatches"] == 8


def test_chunked_tokens_match_whole_slot(smollm):
    gen = _gen(smollm, seed=3)
    reqs = [next(gen) for _ in range(8)]
    mono = _run_streams(_mk(smollm), [dataclasses.replace(r) for r in reqs])
    eng_c = _mk(smollm, prefill_chunk=CHUNK)
    assert eng_c.chunking
    chunked = _run_streams(eng_c, [dataclasses.replace(r) for r in reqs])
    assert set(mono) == set(chunked)
    by_rid = {r.rid: r for r in reqs}
    for rid, m in mono.items():
        c = chunked[rid]
        assert len(c) == len(m) + 1, (rid, len(c), len(m))
        assert c[1:] == m, rid
        assert c[0] == _first_token(eng_c, by_rid[rid].tokens), rid
    sv = eng_c.stats()["serving"]
    assert sv["prefill_dispatches"] == 0
    assert sv["model_dispatches"] == eng_c.engine_steps


@pytest.mark.parametrize("L", [1, 3, 7, 8, 9, 15, 16, 17, 24, 25], ids=lambda v: f"L{v}")
def test_chunk_boundaries(smollm, L):
    eng = _mk(smollm, max_batch=2, prefill_chunk=CHUNK)
    rng = np.random.default_rng(L)
    tokens = rng.integers(0, smollm[0].cfg.vocab_size, size=L).astype(np.int32)
    eng.submit(Request(0, tokens, 3, -1, 0.0))
    prefill_steps = steps = 0
    while (eng.queue or any(s.active for s in eng.slots)) and steps < 60:
        eng.step()
        steps += 1
        prefill_steps += any(s.prefilling for s in eng.slots)
    assert not any(s.active for s in eng.slots)
    expect = -(-L // CHUNK)
    # the prompt-completing step is not seen mid-prefill by the probe
    assert prefill_steps == expect - 1, (L, prefill_steps)
    assert steps == expect + 3, (L, steps)  # + decode_len
    assert eng.stats()["serving"]["prefill_dispatches"] == 0
    # every chunk column the prompt needed ran, and no more
    assert eng.chunk_columns == L


def test_slot_reuse_after_early_completion(smollm):
    """A request admitted into a recycled slot (zeroed in place) decodes
    the stream it gets on a fresh engine."""
    rng = np.random.default_rng(11)
    vocab = smollm[0].cfg.vocab_size
    early = Request(0, rng.integers(0, vocab, 10).astype(np.int32), 2, -1, 0.0)
    stayer = Request(1, rng.integers(0, vocab, 20).astype(np.int32), 12, -1, 0.0)
    late = Request(2, rng.integers(0, vocab, 12).astype(np.int32), 4, -1, 0.0)
    shared = _run_streams(_mk(smollm, max_batch=2, prefill_chunk=4),
                          [dataclasses.replace(r) for r in (early, stayer, late)])
    alone = _run_streams(_mk(smollm, max_batch=2, prefill_chunk=4), [dataclasses.replace(late)])
    assert shared[late.rid] == alone[late.rid]
    assert len(shared) == 3


def test_ttft_histogram_pins_percentiles(smollm):
    eng = _mk(smollm, prefill_chunk=CHUNK)
    gen = _gen(smollm, seed=9)
    reqs = [next(gen) for _ in range(12)]
    _run_streams(eng, reqs)
    samples = np.asarray(eng.ttft_vt_samples)
    assert len(samples) == len(reqs) and (samples >= 0).all()
    h = eng.metrics.histogram("ttft", tenant="default")
    assert h.count == len(samples)
    ordered = np.sort(samples)
    for q in (0.50, 0.99):
        rank = min(len(ordered), max(1, int(np.ceil(q * len(ordered)))))
        exact = float(ordered[rank - 1])
        assert exact <= float(np.percentile(samples, 100 * q, method="higher")) + 1e-9
        got = h.quantile(q)
        assert got >= exact - 1e-9, (q, got, exact)
        assert got <= max(exact, 1e-12) * h.growth + 1e-9, (q, got, exact)


# ---------------------------------------------------------------------------
# the chunked cases of tests/test_dispatch_budget.py


def test_chunked_prefill_one_dispatch_per_step(smollm, monkeypatch):
    calls = []
    orig_seg = tiered_kv_mod.tiered_lookup_segments
    monkeypatch.setattr(tiered_kv_mod, "tiered_lookup_segments",
                        lambda *a, **k: (calls.append("seg"), orig_seg(*a, **k))[1])
    eng = _mk(smollm, prefill_chunk=CHUNK)
    gen = _gen(smollm)
    for _ in range(N_REQUESTS):
        eng.submit(next(gen))
    mixed = 0
    while (eng.queue or any(s.active for s in eng.slots)) and eng.engine_steps < 200:
        before, dispatches = len(calls), eng.model_dispatches
        prefilling = any(s.prefilling for s in eng.slots) or bool(eng.queue)
        eng.step()
        assert len(calls) - before == 1 and eng.model_dispatches - dispatches == 1
        mixed += prefilling and sum(s.active for s in eng.slots) > 1
    assert mixed > 0, "the workload never mixed prefill with decode"
    sv = eng.stats()["serving"]
    assert sv["prefill_dispatches"] == 0
    assert sv["model_dispatches"] == eng.engine_steps == eng.tiered.dispatches


def test_chunked_drain_cadence_equivalence(smollm):
    """Per-step drains and windowed drains charge the same totals, the
    role plane included."""
    windowed, every_step = (_mk(smollm, prefill_chunk=CHUNK) for _ in range(2))
    for e in (windowed, every_step):
        gen = _gen(smollm, seed=5)
        for _ in range(N_REQUESTS):
            e.submit(next(gen))
    while (windowed.queue or any(s.active for s in windowed.slots)) and windowed.engine_steps < 200:
        windowed.step()
        every_step.step()
        every_step.drain_tier_counters()
    sw, se = windowed.stats(), every_step.stats()
    assert sw["tenants"] == se["tenants"] and sw["near_hit_rate"] == se["near_hit_rate"]
    dw, de = sw["device_tiering"], se["device_tiering"]
    assert (dw["near_hits"], dw["far_hits"]) == (de["near_hits"], de["far_hits"])
    np.testing.assert_array_equal(windowed.role_hits, every_step.role_hits)
    for eng, d in ((windowed, dw), (every_step, de)):
        assert int(eng.role_hits.sum()) == d["near_hits"] + d["far_hits"]
        assert int(eng.role_hits[:, 0].sum()) == d["near_hits"]
        assert d["prefill_near_hits"] + d["prefill_far_hits"] > 0
        assert d["decode_near_hits"] + d["decode_far_hits"] > 0
    assert de["drains"] > dw["drains"]


# ---------------------------------------------------------------------------
# the gate


@pytest.mark.parametrize("arch", ARCHS)
def test_inactive_row_keeps_every_cache_leaf(arch):
    """One decode of a batch of 4 from a random cache, gated with rows 1 and
    3 inactive: their every leaf (K/V, states, shifts, conv tails, length)
    is bit-unchanged, and rows 0 and 2 hold what the ungated decode gives
    them, logits included."""
    api = get_model(get_config(arch).reduced())
    model = api.init(0, device="cpu")
    cache = api.init_cache(4, 32, device="cpu")
    rng = np.random.default_rng(1)
    for key, leaf in cache.items():
        if key == "lengths":
            leaf.copy_(torch.as_tensor([3, 9, 31, 32], dtype=torch.int32))
        else:
            leaf.copy_(torch.as_tensor(rng.standard_normal(tuple(leaf.shape)), dtype=leaf.dtype))
    tokens = torch.as_tensor([[5], [17], [2], [40]], dtype=torch.int32)
    active = torch.tensor([True, False, True, False])
    before = {k: v.clone() for k, v in cache.items()}
    gated = {k: v.clone() for k, v in cache.items()}
    logits_g, out_g = api.decode(model, gated, tokens, active=active)
    logits_u, out_u = api.decode(model, {k: v.clone() for k, v in cache.items()}, tokens)
    for key in cache:
        axis = 0 if cache[key].ndim == 1 else 1
        for row in range(4):
            got = out_g[key].select(axis, row)
            want = (out_u if active[row] else before)[key].select(axis, row)
            assert torch.equal(got, want), (arch, key, row)
    assert torch.equal(logits_g[active], logits_u[active])
    assert all(out_g[k] is gated[k] for k in gated if k != "lengths")
