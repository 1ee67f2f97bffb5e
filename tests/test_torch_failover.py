"""The port's failure machinery against the JAX package's, on the CPU.

One scripted schedule runs on both engines (reduced smollm-360m, the
reference's weights carried over by ``parity.params_from_jax``, device
tiering with identity scales), on the whole-slot path and on the chunked
one (``prefill_chunk=8``), at the same steps:

  * ``lost_window`` before a drain (the undrained plane, quarantined) and
    right after one (nothing left);
  * an epoch-fenced push that lands, then ``fence_placement`` and a stale
    push that is rejected;
  * ``enter_degraded`` (every near row demoted, all reads far), a push
    rejected as ``degraded``, ``exit_degraded`` with a fence, a stale and a
    fresh push;
  * ``stranded_requests`` and ``abort_all`` (the same ``(rid, discarded)``
    pairs; on the chunked path with a slot aborted mid-prompt), then the
    aborted requests re-submitted and run to the end.

Every return value, the per-step next tokens, the tier maps, ``stats()``
and the metrics registry (rejections by reason, degraded entries, aborted
requests) are equal. These stand in for the engine checks of
``tests/test_dispatch_budget.py`` (degraded budget, idempotent drains) and
``tests/test_chaos.py`` (degraded near tier, epoch fencing).
"""
import dataclasses

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

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.workloads import get_profile  # noqa: E402
from repro_torch.data.requests import RequestGenerator  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.parity import params_from_jax  # noqa: E402
from repro_torch.runtime.serving import EngineConfig, ServingEngine  # noqa: E402

ARCH = "smollm-360m"
N_REQUESTS = 8


def _ekw(**over):
    kw = dict(max_batch=4, max_len=64, n_pages=256, near_frac=0.05, placement_window=4,
              device_tiering=True, tiered_identity_scales=True)
    kw.update(over)
    return kw


def _prof(get):
    return dataclasses.replace(get("Web1"), prompt_mean=24, decode_mean=10,
                               prefix_share=0.5, n_prefixes=2)


def _near(eng) -> int:
    return int((eng.placement.tier == 0).sum())


def script(eng, gen):
    """The schedule; returns what each call returned, the per-step next
    tokens and tier maps, and the final books."""
    out, tokens, tiers = {}, [], []

    def step(n=1):
        for _ in range(n):
            eng.step()
            tokens.append(np.asarray(eng.next_tokens).copy())
            tiers.append(eng.placement.tier.copy())
            np.testing.assert_array_equal(eng.tiered.tier_host, eng.placement.tier)

    for _ in range(N_REQUESTS):
        eng.submit(next(gen))
    step(3)
    out["lost_before_drain"] = eng.lost_window()
    step(2)
    eng.drain_tier_counters()
    out["lost_after_drain"] = eng.lost_window()
    out["push_epoch1"] = eng.apply_placement(np.arange(40, 52), epoch=1)
    eng.fence_placement(3)
    out["push_stale"] = eng.apply_placement(np.arange(60, 70), epoch=3)
    out["near_before_degrade"] = _near(eng)
    out["degrade"] = eng.enter_degraded(fence_epoch=4)
    out["degrade_again"] = eng.enter_degraded()
    out["near_degraded"] = _near(eng)
    hits0 = (eng.placement.stats.near_hits, eng.placement.stats.far_hits)
    d0, s0, st0 = eng.tiered.dispatches, eng.tiered.host_syncs, eng.engine_steps
    step(5)
    eng.drain_tier_counters()
    out["degraded_hits"] = (eng.placement.stats.near_hits - hits0[0],
                            eng.placement.stats.far_hits - hits0[1])
    out["degraded_budget"] = (eng.tiered.dispatches - d0, eng.tiered.host_syncs - s0,
                              eng.engine_steps - st0)
    out["push_degraded"] = eng.apply_placement(np.arange(5), epoch=9)
    eng.exit_degraded(fence_epoch=5)
    out["near_restored"] = _near(eng)
    out["push_stale_after"] = eng.apply_placement(np.arange(5), epoch=5)
    out["push_fresh"] = eng.apply_placement(np.arange(5), epoch=6)
    step(2)
    out["prefilling_at_abort"] = sum(s.prefilling for s in eng.slots)
    out["stranded"] = [(r.rid, d) for r, d in eng.stranded_requests()]
    aborted = eng.abort_all()
    out["aborted"] = [(r.rid, d) for r, d in aborted]
    out["empty_after_abort"] = (eng.load, eng.backlog_tokens())
    for r, _ in aborted:
        eng.submit(r)
    out["load_resubmitted"] = (eng.load, eng.backlog_tokens(), eng.backlog_tokens(0.5))
    while (eng.queue or any(s.active for s in eng.slots)) and eng.engine_steps < 400:
        step()
    out["stats"] = eng.stats()
    out["metrics"] = eng.metrics.snapshot().flat()
    return out, np.array(tokens), np.array(tiers)


@pytest.fixture(scope="module")
def models():
    cfg = jax_config(ARCH).reduced()
    japi = jax_model(cfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    api = get_model(get_config(ARCH).reduced())
    model = api.init(0, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    return (japi, jparams), (api, model)


@pytest.fixture(scope="module", params=[0, 8], ids=["whole_slot", "chunked"])
def runs(models, request):
    (japi, jparams), (api, model) = models
    over = dict(prefill_chunk=request.param)
    jeng = JaxEngine(japi, jparams, JaxEngineConfig(**_ekw(**over)), seed=0)
    teng = ServingEngine(api, model, EngineConfig(**_ekw(**over)), seed=0, device="cpu")
    vocab = api.cfg.vocab_size
    jres = script(jeng, JaxGenerator(_prof(jax_profile), vocab_size=vocab, seed=0))
    tres = script(teng, RequestGenerator(_prof(get_profile), vocab_size=vocab, seed=0))
    return {"jax": jres, "port": tres, "chunk": request.param, "engine": teng}


def test_returns_equal(runs):
    t, j = runs["port"][0], runs["jax"][0]
    assert {k: v for k, v in t.items() if k not in ("stats", "metrics")} == {
        k: v for k, v in j.items() if k not in ("stats", "metrics")}


def test_tokens_and_tier_maps_equal(runs):
    (_, tt, tm), (_, jt, jm) = runs["port"], runs["jax"]
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tm, jm)


def test_books_equal(runs):
    t, j = runs["port"][0], runs["jax"][0]
    assert t["stats"] == j["stats"]
    assert t["metrics"] == j["metrics"]


def test_failure_contracts(runs):
    """What the schedule must have exercised, on the port's own numbers."""
    out, eng = runs["port"][0], runs["engine"]
    assert out["lost_before_drain"]["steps_undrained"] == 3
    assert out["lost_before_drain"]["near"] + out["lost_before_drain"]["far"] > 0
    assert out["lost_after_drain"] == {"steps_undrained": 0, "near": 0, "far": 0}
    assert out["push_epoch1"] > 0 and out["push_stale"] == 0
    assert out["degrade"] == out["near_before_degrade"] > 0 and out["degrade_again"] == 0
    assert out["near_degraded"] == 0 and out["near_restored"] == 0
    near, far = out["degraded_hits"]
    assert near == 0 and far > 0
    dispatches, syncs, steps = out["degraded_budget"]
    assert dispatches == steps == 5 and syncs < steps
    assert out["push_degraded"] == 0 and out["push_stale_after"] == 0 and out["push_fresh"] > 0
    assert out["aborted"] == out["stranded"] and len(out["aborted"]) > 0
    assert any(d > 0 for _, d in out["aborted"])
    if runs["chunk"]:
        assert out["prefilling_at_abort"] > 0
    assert out["empty_after_abort"] == (0, 0.0)
    m = out["metrics"]
    assert m['placement_rejected{reason=stale_epoch}'] == 2
    assert m['placement_rejected{reason=degraded}'] == 1
    assert m["degraded_entries"] == 1 and m["requests_aborted"] == len(out["aborted"])
    assert out["stats"]["requests_finished"] == N_REQUESTS
    assert not eng.degraded and eng._placement_fence == 5
