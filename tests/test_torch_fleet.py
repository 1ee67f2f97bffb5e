"""The port's fleet (``repro_torch.fleet``) against the JAX package's, on the CPU.

One pair of runs, read by every test here: ``benchmarks/chaos_bench.py``'s
kill-recover scenario (three replicas, two tenants behind an admission
controller, the AutoTierer and the elastic layer, a crash of host 1 with a
replacement host and a hang of host 0), plus a degrade of host 2 over a
window that holds two placement epochs, on device-tiered engines with
trace prediction and the prefetch issue window on. The JAX fleet builds
its reduced smollm-360m as it always does; the port's ``build_fleet``
(``device="cpu"``) gets the same weights through its model cache, seeded
with ``parity.params_from_jax`` and cleared afterwards.

The fleet's books do not depend on token values (no EOS, no wall clock in
the router), so the chaos log, the recorded event order, the outcome
ledger, ``fleet_stats`` (per-replica books included), the merged metric
snapshots, every AutoTierer epoch (near set, prefetch tables, budgets) and
the elastic scale events are equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import repro.fleet as jax_fleet  # noqa: E402
from repro.configs.workloads import get_profile as jax_profile  # noqa: E402
from repro.data.requests import RequestGenerator as JaxGenerator  # noqa: E402
from repro.data.requests import interleave as jax_interleave  # noqa: E402
from repro.obs import FlightRecorder as JaxRecorder  # noqa: E402

import repro_torch.fleet as port_fleet  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.workloads import get_profile  # noqa: E402
from repro_torch.data.requests import RequestGenerator, interleave  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.obs import FlightRecorder  # noqa: E402
from repro_torch.parity import params_from_jax  # noqa: E402
from repro_torch.runtime.sharded import ShardedServingEngine  # noqa: E402

ARCH = "smollm-360m"
N_REQUESTS = 24
TENANTS = {  # benchmarks/chaos_bench.py's pair
    "web": dict(base="Web1", rate=8.0, slo=96.0,
                overrides=dict(prompt_mean=24, decode_mean=8, prefix_share=0.9, n_prefixes=3)),
    "cache": dict(base="Cache1", rate=32.0, slo=12.0,
                  overrides=dict(prompt_mean=8, decode_mean=6, prefix_share=0.0, n_prefixes=4)),
}
# chaos_bench's kill-recover schedule, and host 2 degraded over vtime 14-26
# (the AutoTierer's epochs at 16 and 24 fall inside)
SCENARIO = [("crash", 6.0, 1, 6.0), ("hang", 10.0, 0, 3.0), ("degrade", 14.0, 2, 12.0)]


def run_fleet(pkg, generator, interleave_fn, profile, recorder, **extra):
    fleet = pkg.build_fleet(
        3,
        policy="least-loaded",
        trace_window=16,
        trace_period=32,
        admission=pkg.AdmissionController(
            pkg.SLOModel(max_delay_steps=64.0),
            tenant_slos={t: pkg.SLOModel(max_delay_steps=s["slo"]) for t, s in TENANTS.items()},
        ),
        autotier=dict(near_frac=0.30, epoch_steps=8),
        elastic=dict(min_replicas=1, max_replicas=4),
        seed=0,
        recorder=recorder,
        device_tiering=True,
        predictor="trace",
        prefetch_promote=True,
        **extra,
    )
    pkg.ChaosEngine(fleet, [pkg.FaultEvent(t, kind, rid=rid, duration=d) for kind, t, rid, d in SCENARIO],
                    dispatch_timeout=8.0, max_retries=3)
    gens = [
        generator(dataclasses.replace(profile(s["base"]), **s["overrides"]),
                  vocab_size=pkg.fleet_vocab(), seed=i, rate=s["rate"], tenant=t)
        for i, (t, s) in enumerate(sorted(TENANTS.items()))
    ]
    stats = fleet.run(iter(interleave_fn(gens, N_REQUESTS)), n_requests=N_REQUESTS, max_steps=600,
                      submit_per_step=3)
    return fleet, stats


def norm(x):
    """Plain Python values: dataclasses as dicts, arrays as lists."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return norm({f.name: getattr(x, f.name) for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def _spans(rec):
    return [(s.name, s.trace, s.t0, s.t1, s.tenant, s.replica, s.kind, norm(s.args))
            for s in rec.spans.finished()]


def _read(fleet, stats, rec):
    return {
        "log": list(fleet.chaos.log),
        "spans": _spans(rec),
        "scheduler": (fleet.scheduler.events_run, fleet.scheduler.events_cancelled,
                      fleet.scheduler.batches),
        "outcome": fleet.outcome_report(),
        "run_stats": norm(stats),
        "fleet_stats": norm(fleet.fleet_stats()),
        "merged": fleet.fleet_metrics().flat(),
        "snapshots": [s.flat() for s in fleet.metric_snapshots()],
        "metric_rows": rec.metric_rows,
        "epochs": norm(fleet.autotierer.history),
        "scale_events": norm(fleet.elastic.events),
        "per_host": {r.rid: (r.engine.engine_steps, r.engine.stats()["prefetch_promoted_pages"],
                             r.engine.metrics.snapshot().flat()) for r in fleet.replicas},
    }


@pytest.fixture(scope="module")
def pair():
    jrec = JaxRecorder()
    jfl, jst = run_fleet(jax_fleet, JaxGenerator, jax_interleave, jax_profile, jrec)
    cfg, api, jparams = jax_fleet._MODEL_CACHE[ARCH]
    papi = get_model(get_config(ARCH).reduced())
    model = papi.init(0, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    port_fleet._MODEL_CACHE[(ARCH, "cpu")] = (papi.cfg, papi, model)
    try:
        prec = FlightRecorder()
        pfl, pst = run_fleet(port_fleet, RequestGenerator, interleave, get_profile, prec, device="cpu")
    finally:
        port_fleet._MODEL_CACHE.pop((ARCH, "cpu"), None)
    return {"jax": _read(jfl, jst, jrec), "port": _read(pfl, pst, prec)}


def test_chaos_log_and_event_order(pair):
    p, j = pair["port"], pair["jax"]
    assert p["log"] == j["log"]
    applied = [(a, rid) for _, a, rid, ok in p["log"] if ok]
    assert applied == [("crash", 1), ("hang", 0), ("crash_recover", 3), ("hang_recover", 0),
                       ("degrade", 2), ("degrade_recover", 2)]
    assert p["scheduler"] == j["scheduler"]
    assert p["spans"] == j["spans"] and len(p["spans"]) > 100


def test_outcome_report(pair):
    p, j = pair["port"]["outcome"], pair["jax"]["outcome"]
    assert p == j
    assert p["complete"] and p["offered"] == N_REQUESTS
    assert sum(p["outcomes"].values()) == p["offered"]


def test_fleet_stats(pair):
    p, j = pair["port"], pair["jax"]
    assert p["run_stats"] == j["run_stats"]
    assert p["fleet_stats"] == j["fleet_stats"]
    assert p["fleet_stats"]["failovers"] >= 1 and p["fleet_stats"]["lost_tokens"] > 0


def test_merged_metric_snapshots(pair):
    p, j = pair["port"], pair["jax"]
    assert p["merged"] == j["merged"]
    assert p["snapshots"] == j["snapshots"]
    assert p["metric_rows"] == j["metric_rows"]
    assert p["per_host"] == j["per_host"]


def test_degraded_host_rejects_pushes(pair):
    """Host 2's pushes inside its degraded window (the epochs at 16 and 24)
    bounce with reason ``degraded``, between one degraded and one restored
    instant on its track."""
    snaps = pair["port"]["per_host"]
    assert snaps[2][2]["placement_rejected{reason=degraded,replica=2}"] == 2
    assert snaps[2][2]["degraded_entries{replica=2}"] == 1
    host2 = [s for s in pair["port"]["spans"] if s[5] == 2 and s[0] in ("degraded", "restored")]
    assert [s[0] for s in host2] == ["degraded", "restored"]


def test_autotier_epochs(pair):
    p, j = pair["port"]["epochs"], pair["jax"]["epochs"]
    assert p == j
    assert len(p) >= 3 and any(e["prefetch_table"] for e in p)


def test_elastic_scale_events(pair):
    p, j = pair["port"]["scale_events"], pair["jax"]["scale_events"]
    assert p == j
    assert [(e["action"], e["rid"]) for e in p][:2] == [("crash", 1), ("up", 3)]


def test_build_fleet_wants_the_card_and_names_what_is_missing():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_fleet.build_fleet(1)
    sharded = port_fleet.build_fleet(2, device="cpu", device_tiering=True, model_shards=2)
    assert all(isinstance(r.engine, ShardedServingEngine) and r.engine.tiered.n_shards == 2
               for r in sharded.replicas)
    with pytest.raises(NotImplementedError, match="A9"):
        port_fleet.restored_params_source(None, None)
    port_fleet._MODEL_CACHE.pop((ARCH, "cpu"), None)
