"""The port's ServingEngine against the JAX package's, on the reduced
smollm-360m engine of ``tests/test_dispatch_budget.py`` with its Web1 traffic.

Parameters are the reference's, carried over by ``parity.params_from_jax``.
Tokens, live counters, the whole ``stats()`` book and the tier maps are
integer (or integer-derived) functions of the schedule and must be equal.
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
from repro.models.api import get_model as jax_model  # noqa: E402
from repro.runtime.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.runtime.serving import ServingEngine as JaxEngine  # noqa: E402
from repro.runtime.serving import counter_rows as jax_counter_rows  # noqa: E402

import repro_torch.runtime.tiered_kv as tiered_kv_mod  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.workloads import get_profile  # noqa: E402
from repro_torch.data.requests import RequestGenerator  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.parity import params_from_jax  # noqa: E402
from repro_torch.runtime.serving import EngineConfig, ServingEngine, counter_rows  # noqa: E402

ARCH = "smollm-360m"
N_REQUESTS = 6


def _ekw(device: bool, **over):
    kw = dict(
        max_batch=4, max_len=64, n_pages=256, near_frac=0.02, placement_window=4,
        device_tiering=device, tiered_identity_scales=device, tiered_verify=device,
    )
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


@pytest.fixture(scope="module")
def reference():
    """The JAX engine's run (device tiering, identity scales). Its in-line
    verify probe is left off to keep the run short: it changes no book, and
    the port's run keeps it on."""
    cfg = jax_config(ARCH).reduced()
    api = jax_model(cfg)
    params = api.init(jax.random.PRNGKey(0))
    eng = JaxEngine(api, params, JaxEngineConfig(**_ekw(True, tiered_verify=False)), seed=0)
    tokens = _run(eng, JaxGenerator(_prof(jax_profile), vocab_size=cfg.vocab_size, seed=0))
    return {
        "tokens": tokens,
        "live": eng.live_counters(),
        "stats": eng.stats(),
        "tier": eng.placement.tier.copy(),
        "tier_host": eng.tiered.tier_host.copy(),
        "slot_host": eng.tiered.slot_host.copy(),
        "engine": eng,
        "params": params,
    }


@pytest.fixture(scope="module")
def port(reference):
    """The port's api and model, holding the reference's parameters."""
    api = get_model(get_config(ARCH).reduced())
    model = api.init(0, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, reference["params"])))
    return api, model


def _engine(port, device: bool, **over):
    api, model = port
    return ServingEngine(api, model, EngineConfig(**_ekw(device, **over)), seed=0, device="cpu")


def _gen(port, seed=0):
    return RequestGenerator(_prof(get_profile), vocab_size=port[0].cfg.vocab_size, seed=seed)


def test_device_tiered_engine_matches_reference(reference, port):
    eng = _engine(port, True)
    tokens = _run(eng, _gen(port))
    np.testing.assert_array_equal(tokens, reference["tokens"])
    assert eng.live_counters() == reference["live"]
    st = eng.stats()
    assert st == reference["stats"]
    dev = st["device_tiering"]
    assert dev["max_read_error"] == 0.0
    assert dev["near_hits"] > 0 and dev["far_hits"] > 0
    assert dev["dispatches_per_step"] == 1.0
    np.testing.assert_array_equal(eng.placement.tier, reference["tier"])
    np.testing.assert_array_equal(eng.tiered.tier_host, reference["tier_host"])
    np.testing.assert_array_equal(eng.tiered.slot_host, reference["slot_host"])


def test_tiering_off_gives_the_same_result(reference, port):
    """The acceptance oracle of the reference: host-accounted tiering gives
    the tokens and live counters of device-executed tiering."""
    eng = _engine(port, False)
    tokens = _run(eng, _gen(port))
    np.testing.assert_array_equal(tokens, reference["tokens"])
    assert eng.live_counters() == reference["live"]
    st, ref = eng.stats(), reference["stats"]
    assert st["device_tiering"] is None
    for key in ("tokens_decoded", "requests_finished", "near_hit_rate", "migrations",
                "prefill_tokens", "prefetch_accuracy", "prefetch_coverage", "tenants", "pagetable"):
        assert st[key] == ref[key], key


def test_one_tiered_dispatch_per_step(port, monkeypatch):
    calls = []
    orig_seg = tiered_kv_mod.tiered_lookup_segments
    orig_cnt = tiered_kv_mod.tiered_lookup_counted
    monkeypatch.setattr(tiered_kv_mod, "tiered_lookup_segments",
                        lambda *a, **k: (calls.append("seg"), orig_seg(*a, **k))[1])
    monkeypatch.setattr(tiered_kv_mod, "tiered_lookup_counted",
                        lambda *a, **k: (calls.append("cnt"), orig_cnt(*a, **k))[1])
    eng = _engine(port, True, tiered_verify=False)
    gen = _gen(port)
    for _ in range(N_REQUESTS):
        eng.submit(next(gen))
    multi = 0
    while eng.queue or any(s.active for s in eng.slots):
        before = len(calls)
        eng.step()
        assert len(calls) - before == 1
        multi += sum(1 for s in eng.slots if s.active) > 1
    assert multi > 0 and set(calls) == {"seg"}
    assert eng.tiered.dispatches == len(calls) == eng.engine_steps


def test_per_slot_baseline_pays_a_dispatch_per_slot(port):
    seg = _engine(port, True, tiered_verify=False)
    _run(seg, _gen(port))
    per_slot = _engine(port, True, segmented_lookup=False)
    _run(per_slot, _gen(port))
    ds, dp = seg.stats()["device_tiering"], per_slot.stats()["device_tiering"]
    assert dp["dispatches_per_step"] > 1.0 and dp["host_syncs_per_step"] >= 1.0
    assert dp["max_read_error"] == 0.0
    assert (dp["near_hits"], dp["far_hits"]) == (ds["near_hits"], ds["far_hits"])
    assert per_slot.live_counters() == seg.live_counters()


def test_counter_drain_cadence_equivalence(port):
    windowed, every_step = _engine(port, True), _engine(port, True)
    gw, ge = _gen(port, seed=5), _gen(port, seed=5)
    for _ in range(N_REQUESTS):
        windowed.submit(next(gw))
        every_step.submit(next(ge))
    while windowed.queue or any(s.active for s in windowed.slots):
        windowed.step()
        every_step.step()
        every_step.drain_tier_counters()
    sw, se = windowed.stats(), every_step.stats()
    assert sw["tenants"] == se["tenants"] and sw["near_hit_rate"] == se["near_hit_rate"]
    dw, de = sw["device_tiering"], se["device_tiering"]
    assert (dw["near_hits"], dw["far_hits"]) == (de["near_hits"], de["far_hits"])
    assert de["drains"] > dw["drains"]


def test_payload_rows_match_reference(reference, port):
    """The same cache through both engines' _payload_rows: the (n, 2L*Hkv*hd)
    rows are bit-exact. NumPy, JAX and PyTorch all move the two separated
    advanced indices (batch, position) to the front, so each row is the
    k vectors of every layer and head, then the v vectors."""
    jeng = reference["engine"]
    teng = _engine(port, True)
    rng = np.random.default_rng(3)
    shape = tuple(teng.cache["k"].shape)  # (L, B, Hkv, S, hd)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    bi, pos = [0, 2, 2, 3, 1], [5, 0, 63, 17, 17]
    rows_t = teng._payload_rows({"k": torch.from_numpy(k), "v": torch.from_numpy(v)}, bi, pos, [0] * 5)
    rows_j = jeng._payload_rows({"k": jnp.asarray(k), "v": jnp.asarray(v)}, bi, pos, [0] * 5)
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))
    loop = np.stack([np.concatenate([k[:, b, :, p, :], v[:, b, :, p, :]]).reshape(-1)
                     for b, p in zip(bi, pos)])
    np.testing.assert_array_equal(rows_t.numpy(), loop)
    assert rows_t.shape == (5, 2 * shape[0] * shape[2] * shape[4])


def test_counter_rows_match_reference():
    rng = np.random.default_rng(0)
    pids, vers = rng.integers(0, 500, 7), rng.integers(0, 9, 7)
    np.testing.assert_array_equal(counter_rows(3, pids, vers, 40), jax_counter_rows(3, pids, vers, 40))


def test_unported_options_name_their_roadmap_item(port):
    """The sharded engine is the one engine option not ported yet."""
    with pytest.raises(NotImplementedError, match="A7"):
        _engine(port, True, model_shards=2)
