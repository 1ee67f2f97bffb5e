"""Fleet subsystem: multi-replica serving with fleet-wide MemProf.

The paper's observations are fleet-level — the same code runs on many
hosts, and both its profiler and its tracer only become *representative*
when aggregated across them. Module -> paper-section map:

* ``replica.py``  — one profiled host: engine + live hardware-counter
  analogue (§3's per-host collection; Table 6's "live" column), with its
  own clock/speed factor and a drain protocol for elastic scale-down.
* ``scheduler.py`` — deterministic virtual-time event loop: per-replica
  completion events instead of a global barrier, so a straggler slows one
  host, not the fleet step (per-host heterogeneity is first-order at
  hyperscale).
* ``router.py``   — request placement across hosts; prefix-affinity is the
  fleet form of the multi-ASID shared-TLB idea (§4 / Fig. 17): same-template
  requests land where those KV translations already live. Dispatch runs
  from weighted-fair tenant queues at every completion batch (lockstep kept
  as a compatibility mode).
* ``aggregator.py`` — fleet MemProf: sums per-page counts over hosts
  (§4, Fig. 6/9/18) and stitches short attach/detach trace windows from
  multiple hosts into one representative trace, validated by cache-sim
  replay against live counters (§6.2-§6.3, Table 6).
* ``autotier.py`` — online re-tiering from the aggregated histogram
  (§5, Table 4/5): plan on fleet behavior, push placement to every host;
  epochs keyed on virtual time over the (possibly changing) replica set.
* ``admission.py`` — overload sheds at the door instead of pushing the
  far tier past its latency knee (§2, Fig. 4); exports the door-pressure
  signal elasticity scales on.
* ``elastic.py``  — replica set scales with load: scale-up warms its near
  tier from the fleet plan, scale-down drains and folds the host's profile
  into the aggregate.
* ``faults.py``   — deterministic chaos: seeded crash/hang/slowdown/degrade
  faults as first-class scheduler events, replica failover with retry and
  dedup-guarded re-dispatch, crash salvage with quantified loss windows —
  same seed, same run, bit for bit.

``build_fleet`` wires it together over the port's engines; on the card,
``chip_smoke.py``'s fleet phase wires the same objects over full-width
engines.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.device import resolve_device
from repro_torch.fleet.admission import AdmissionController, SLOModel
from repro_torch.fleet.aggregator import (
    aggregate_counts,
    aggregate_metrics,
    aggregate_tenant_counts,
    export_all,
    fleet_report,
    live_fleet_counters,
    stitch_fleet,
    validate_fleet,
)
from repro_torch.fleet.autotier import AutoTierer, TierEpoch
from repro_torch.fleet.elastic import ElasticFleet, ScaleEvent, restored_params_source
from repro_torch.fleet.faults import ChaosEngine, FaultEvent
from repro_torch.fleet.replica import Replica, ReplicaProfile
from repro_torch.fleet.router import (
    POLICIES,
    FleetRouter,
    LeastLoadedPolicy,
    PrefixAffinityPolicy,
    RoundRobinPolicy,
    simulated_throughput,
)
from repro_torch.fleet.scheduler import VirtualScheduler

__all__ = [
    "AdmissionController",
    "SLOModel",
    "AutoTierer",
    "TierEpoch",
    "ElasticFleet",
    "ScaleEvent",
    "restored_params_source",
    "ChaosEngine",
    "FaultEvent",
    "Replica",
    "ReplicaProfile",
    "FleetRouter",
    "RoundRobinPolicy",
    "LeastLoadedPolicy",
    "PrefixAffinityPolicy",
    "POLICIES",
    "VirtualScheduler",
    "simulated_throughput",
    "aggregate_counts",
    "aggregate_metrics",
    "aggregate_tenant_counts",
    "export_all",
    "fleet_report",
    "live_fleet_counters",
    "stitch_fleet",
    "validate_fleet",
    "build_fleet",
]

_MODEL_CACHE: dict = {}


def build_fleet(
    n_replicas: int,
    policy: str = "prefix-affinity",
    arch: str = "smollm-360m",
    admission: Optional[AdmissionController] = None,
    autotier: Optional[dict] = None,
    elastic: Optional[dict] = None,
    live_cache_blocks: int = 128,
    seed: int = 0,
    tenant_weights: Optional[dict] = None,
    speeds: Optional[Sequence[float]] = None,
    recorder=None,
    device=None,
    mesh=None,
    **engine_kwargs,
) -> FleetRouter:
    """Construct N replicas sharing one model (params and their held casts),
    a router with the named policy, and optionally admission/autotiering/
    elasticity.

    ``autotier`` kwargs (near_frac, epoch_steps) attach an AutoTierer as an
    on_step hook and return it as ``router.autotierer``. ``elastic`` kwargs
    (min_replicas, max_replicas, thresholds, cooldown; optional
    ``params_source`` for checkpoint-restored weights) attach an
    ElasticFleet as ``router.elastic`` — scaled-up replicas are built by
    the same factory as the initial set and warm their near tier from the
    AutoTierer's latest plan. ``speeds`` gives per-replica step-cost
    multipliers (e.g. ``(1, 1, 1, 4)`` for a 4x straggler on host 3).
    ``tenant_weights`` sets the router's weighted-fair dispatch shares for
    multi-tenant traffic (see fleet/router.py); per-tenant SLOs live on the
    AdmissionController (``tenant_slos``).

    ``recorder`` attaches an ``obs.FlightRecorder`` (request-lifecycle
    spans + unified metrics, exportable to Perfetto): every replica —
    including elastically added ones — emits through it on the fleet's
    virtual clock. Defaults to the process-global recorder, if one is
    installed (``obs.set_default_recorder`` / ``REPRO_FLIGHT_RECORDER=1``).

    ``mesh``, a ``("model",)`` mesh of ``model_shards`` ranks
    (``launch.mesh.make_serving_mesh``): each replica with ``model_shards >
    1`` spans it (``ShardedServingEngine(mesh=)``), its store one shard a
    rank. Every rank of the mesh builds the same fleet and runs the same
    router with the same calls; the router reads the replicas' books, which
    each step merges across the ranks by all-reduce, so every rank routes
    alike.

    ``device`` is where every replica runs: None means the CUDA card (and
    raises without one), tests pass ``"cpu"``. The model is the reduced
    config, whose attention head_dim of 16 the card's kernels do not take:
    on the card this raises, and a caller that wants a fleet there wires
    the same objects over a model the kernels take (``chip_smoke.py``).
    """
    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model
    from repro_torch.runtime.serving import EngineConfig, ServingEngine

    dev = resolve_device(device)
    key = (arch, str(dev))
    if key not in _MODEL_CACHE:
        cfg = get_config(arch).reduced()
        api = get_model(cfg)
        _MODEL_CACHE[key] = (cfg, api, api.init(0, device=dev))
    cfg, api, params = _MODEL_CACHE[key]
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}; choose from {sorted(POLICIES)}")
    if speeds is not None and len(speeds) != n_replicas:
        raise ValueError(f"speeds must have one entry per replica ({n_replicas})")
    kw = dict(max_batch=4, max_len=64, n_pages=512)
    kw.update(engine_kwargs)
    ekw = dict(elastic or {})
    params_source = ekw.pop("params_source", None)

    def make_replica(rid: int, speed: float = 1.0) -> Replica:
        p = params_source() if params_source is not None else params
        ecfg = EngineConfig(**kw)
        if ecfg.model_shards > 1:
            # one LOGICAL replica over a sharded store: still one routing
            # target, one profile export, one tenant book — the shards are
            # invisible to the router and merge by summation above this
            from repro_torch.runtime.sharded import ShardedServingEngine

            eng = ShardedServingEngine(api, p, ecfg, seed=seed + rid, device=dev, mesh=mesh)
        else:
            eng = ServingEngine(api, p, ecfg, seed=seed + rid, device=dev)
        return Replica(rid, eng, live_cache_blocks, speed=speed)

    replicas = [
        make_replica(i, 1.0 if speeds is None else float(speeds[i]))
        for i in range(n_replicas)
    ]
    router = FleetRouter(
        replicas, POLICIES[policy](), admission=admission, tenant_weights=tenant_weights
    )
    if recorder is not None:
        router.attach_recorder(recorder)
    if autotier is not None:
        router.autotierer = AutoTierer(replicas, **autotier)
        router.on_step.append(router.autotierer)
    if elastic is not None:
        router.elastic = ElasticFleet(
            router, make_replica, autotierer=router.autotierer, **ekw
        )
        router.on_step.append(router.elastic)
    return router


def fleet_vocab(arch: str = "smollm-360m") -> int:
    """Vocab size of the reduced model — for RequestGenerators."""
    from repro_torch.configs import get_config

    return get_config(arch).reduced().vocab_size
