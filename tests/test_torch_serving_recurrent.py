"""The port's ServingEngine against the JAX package's on the two recurrent
families, reduced rwkv6-7b (ssm) and reduced zamba2-1.2b (hybrid), with the
settings and Web1 traffic of ``tests/test_torch_serving.py``.

The engine is family-generic: rwkv6's O(1) state feeds the tier store
synthetic ``counter_rows`` payloads, zamba2's shared-attention KV cache
(n_apps, B, Hkv, S, hd) feeds real ones. Parameters are the reference's,
carried over by ``parity.params_from_jax``. Tokens, live counters, the
whole ``stats()`` book and the tier maps are integer (or integer-derived)
functions of the schedule and must be equal.
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

N_REQUESTS = 6
ARCHS = ["rwkv6-7b", "zamba2-1.2b"]


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


def _run(eng, gen):
    for _ in range(N_REQUESTS):
        eng.submit(next(gen))
    tokens = []
    while (eng.queue or any(s.active for s in eng.slots)) and eng.engine_steps < 400:
        eng.step()
        tokens.append(np.asarray(eng.next_tokens).copy())
    return np.array(tokens)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """The JAX engine's run (device tiering, identity scales; its in-line
    verify probe off to keep it short: it changes no book), and the port's
    api and model holding the same parameters."""
    arch = request.param
    cfg = jax_config(arch).reduced()
    api = jax_model(cfg)
    params = api.init(jax.random.PRNGKey(0))
    eng = JaxEngine(api, params, JaxEngineConfig(**_ekw(True, tiered_verify=False)), seed=0)
    tokens = _run(eng, JaxGenerator(_prof(jax_profile), vocab_size=cfg.vocab_size, seed=0))
    tapi = get_model(get_config(arch).reduced())
    model = tapi.init(0, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    ref = {
        "tokens": tokens,
        "live": eng.live_counters(),
        "stats": eng.stats(),
        "tier": eng.placement.tier.copy(),
        "tier_host": eng.tiered.tier_host.copy(),
        "slot_host": eng.tiered.slot_host.copy(),
        "payload_dim": eng.tiered.row_dim,
    }
    return arch, ref, tapi, model


def _port_run(pair, device: bool):
    _, _, tapi, model = pair
    eng = ServingEngine(tapi, model, EngineConfig(**_ekw(device)), seed=0, device="cpu")
    gen = RequestGenerator(_prof(get_profile), vocab_size=tapi.cfg.vocab_size, seed=0)
    return eng, _run(eng, gen)


def test_device_tiered_engine_matches_reference(pair):
    arch, ref, tapi, _ = pair
    eng, tokens = _port_run(pair, True)
    np.testing.assert_array_equal(tokens, ref["tokens"])
    assert eng.live_counters() == ref["live"]
    st = eng.stats()
    assert st == ref["stats"]
    dev = st["device_tiering"]
    assert dev["max_read_error"] == 0.0
    assert dev["near_hits"] > 0 and dev["far_hits"] > 0
    assert dev["dispatches_per_step"] == 1.0
    np.testing.assert_array_equal(eng.placement.tier, ref["tier"])
    np.testing.assert_array_equal(eng.tiered.tier_host, ref["tier_host"])
    np.testing.assert_array_equal(eng.tiered.slot_host, ref["slot_host"])
    # rwkv6 has no KV cache: synthetic rows; zamba2's rows are its shared-block k and v
    cfg = tapi.cfg
    want = 128 if arch == "rwkv6-7b" else 2 * (cfg.n_layers // cfg.shared_attn_every) * cfg.n_kv_heads * cfg.head_dim
    assert eng.tiered.row_dim == ref["payload_dim"] == want


def test_tiering_off_gives_the_same_result(pair):
    _, ref, _, _ = pair
    eng, tokens = _port_run(pair, False)
    np.testing.assert_array_equal(tokens, ref["tokens"])
    assert eng.live_counters() == ref["live"]
    assert eng.stats()["device_tiering"] is None
