"""The port's prefetch issue window (``prefetch_promote``) against the JAX
package's, on the CPU.

Reduced smollm-360m with the reference's weights (``parity.params_from_jax``),
trace-driven prediction and promotion on, under skewed phase-shifting
template traffic (the shape of ``benchmarks/tiered_decode_bench.py``'s
prefetch scenario, cut to a few dozen steps): one hot template dominates
each phase and the hot template rotates, so the trained successor table
names far template pages before their counts do, and the window promotes
them. On the whole-slot path and on the chunked one (``prefill_chunk=8``,
where a prefilling slot's not-yet-prefilled pages count as upcoming
readers), the per-step next tokens, the tier maps after every step, the
per-step tiered dispatches and host syncs, and the whole ``stats()`` book
(every ``prefetch_*`` entry, ``prefetch_promoted_pages`` > 0) are equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.data.requests import Request as JaxRequest  # noqa: E402
from repro.models.api import get_model as jax_model  # noqa: E402
from repro.runtime.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.runtime.serving import ServingEngine as JaxEngine  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.requests import Request  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.parity import params_from_jax  # noqa: E402
from repro_torch.runtime.serving import EngineConfig, ServingEngine  # noqa: E402

ARCH = "smollm-360m"
WINDOW = 4


def _ekw(**over):
    kw = dict(max_batch=4, max_len=96, n_pages=128, near_frac=0.05, placement_window=WINDOW,
              device_tiering=True, tiered_identity_scales=True, predictor="trace",
              prefetch_promote=True, prefetch_buffer=128, prefetch_lookahead=6)
    kw.update(over)
    return kw


def phase_traffic(vocab, n_requests=24, n_templates=4, phases=6, prompt=48, decode=6,
                  hot_share=0.7, bg_decode=16, seed=7):
    """(tokens, decode_len, template) per request: 70% of each phase's
    arrivals take the phase's hot template, which rotates every phase;
    background requests decode longer, keeping cold chains resident."""
    rng = np.random.default_rng(seed)
    temps = [rng.integers(0, vocab, size=prompt).astype(np.int32) for _ in range(n_templates)]
    per = max(1, n_requests // phases)
    out = []
    for i in range(n_requests):
        hot = min(i // per, phases - 1) % n_templates
        t = hot if rng.random() < hot_share else int(rng.integers(0, n_templates))
        sfx = rng.integers(0, vocab, size=4).astype(np.int32)
        out.append((np.concatenate([temps[t], sfx]), decode if t == hot else bg_decode, t))
    return out


def _drive(eng, reqs):
    """Submit ``reqs`` and step to the end; per step: the next tokens, the
    placement and device tier maps, and the step's tiered dispatches and
    host syncs."""
    for r in reqs:
        eng.submit(r)
    steps = []
    while (eng.queue or any(s.active for s in eng.slots)) and eng.engine_steps < 400:
        d0, s0 = eng.tiered.dispatches, eng.tiered.host_syncs
        eng.step()
        steps.append({
            "tokens": np.asarray(eng.next_tokens).copy(),
            "tier": eng.placement.tier.copy(),
            "tier_host": eng.tiered.tier_host.copy(),
            "dispatches": eng.tiered.dispatches - d0,
            "host_syncs": eng.tiered.host_syncs - s0,
        })
    return steps


@pytest.fixture(scope="module")
def models():
    cfg = jax_config(ARCH).reduced()
    japi = jax_model(cfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    api = get_model(get_config(ARCH).reduced())
    model = api.init(0, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    return (japi, jparams), (api, model), phase_traffic(cfg.vocab_size)


@pytest.fixture(scope="module", params=[0, 8], ids=["whole_slot", "chunked"])
def runs(models, request):
    (japi, jparams), (api, model), traffic = models
    over = dict(prefill_chunk=request.param)
    jeng = JaxEngine(japi, jparams, JaxEngineConfig(**_ekw(**over)), seed=0)
    teng = ServingEngine(api, model, EngineConfig(**_ekw(**over)), seed=0, device="cpu")
    jsteps = _drive(jeng, [JaxRequest(i, t, d, p, float(i)) for i, (t, d, p) in enumerate(traffic)])
    tsteps = _drive(teng, [Request(i, t, d, p, float(i)) for i, (t, d, p) in enumerate(traffic)])
    return {"jax": (jeng, jsteps), "port": (teng, tsteps), "chunk": request.param}


def test_window_promotes_on_both(runs):
    (jeng, _), (teng, _) = runs["jax"], runs["port"]
    js, ts = jeng.stats(), teng.stats()
    assert js["prefetch_promoted_pages"] > 0
    assert ts["prefetch_promoted_pages"] == js["prefetch_promoted_pages"]
    assert teng.chunking == (runs["chunk"] > 0)
    assert ts["tenants"] and ts["requests_finished"] == js["requests_finished"] == 24


def test_tokens_and_tier_maps_every_step(runs):
    (_, jsteps), (_, tsteps) = runs["jax"], runs["port"]
    assert len(tsteps) == len(jsteps)
    for i, (t, j) in enumerate(zip(tsteps, jsteps)):
        np.testing.assert_array_equal(t["tokens"], j["tokens"], err_msg=f"step {i}")
        np.testing.assert_array_equal(t["tier"], j["tier"], err_msg=f"step {i}")
        np.testing.assert_array_equal(t["tier_host"], j["tier_host"], err_msg=f"step {i}")


def test_stats_book_equal(runs):
    (jeng, _), (teng, _) = runs["jax"], runs["port"]
    ts, js = teng.stats(), jeng.stats()
    assert ts == js
    assert {k: v for k, v in ts.items() if k.startswith("prefetch_")} == {
        k: v for k, v in js.items() if k.startswith("prefetch_")}
    assert teng.metrics.snapshot().flat() == jeng.metrics.snapshot().flat()


def test_one_dispatch_and_drain_cadence(runs):
    """One tiered dispatch every step, and host syncs only at the window
    boundaries: the window's migration runs on a clean counter plane."""
    (_, jsteps), (_, tsteps) = runs["jax"], runs["port"]
    for steps in (tsteps, jsteps):
        assert [s["dispatches"] for s in steps] == [1] * len(steps)
        assert [s["host_syncs"] for s in steps] == [
            int((i + 1) % WINDOW == 0) for i in range(len(steps))]
