"""Fleet serving demo on the PyTorch port: 4 replicas, fleet MemProf, online
re-tiering.

The same high-template-share traffic is served twice, once with requests
sprayed round-robin, once with prefix-affinity routing, while the fleet
aggregator stitches every host's attach/detach trace windows into one
representative trace (paper §6.2) and the AutoTierer re-plans placement
from the aggregated histogram (§5). The affinity run must win on the
simulated-throughput cost model. Then a co-located multi-tenant run, a
straggler and an autoscale cycle under the flight recorder, and a chaos
run that kills one of three hosts mid-burst and recovers. The reference's
``examples/serve_fleet.py`` describes each mechanism (tenant config,
event-driven stepping and elasticity, continuous batching, the fault
taxonomy, the flight recorder); the port's fleet (``repro_torch.fleet``)
is the same code over the port's engines.

Every fleet is built by ``build_fleet(device=)`` on ``--device`` (default:
the CUDA card). A fleet's replicas share the reduced smollm-360m; on the
card its attention runs on the flash and paged kernels, which take
head_dim 64, so the example seeds the fleet's model cache with the
reduced config at those widths (``models.api.card_widths``). A fleet's
books follow its schedule, not its token values, so the win conditions
are the same on either device.

PYTHONPATH=src python examples/torch_serve_fleet.py [--trace out.json] [--device cpu]
"""
import argparse
import dataclasses

import torch

from repro_torch.configs.workloads import get_profile
from repro_torch.data.requests import RequestGenerator, interleave
from repro_torch.fleet import (
    AdmissionController,
    ChaosEngine,
    FaultEvent,
    SLOModel,
    build_fleet,
    export_all,
    fleet_report,
    fleet_vocab,
    validate_fleet,
)
from repro_torch import fleet as fleet_pkg
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.api import card_widths, get_model
from repro_torch.obs import FlightRecorder

N_REPLICAS = 4
N_PAGES = 512
ARCH = "smollm-360m"
DEVICE = None  # where every fleet runs: set by main from --device


def serve(policy: str, n_requests: int = 20):
    fleet = build_fleet(
        N_REPLICAS,
        policy=policy,
        n_pages=N_PAGES,
        trace_window=16,
        trace_period=32,
        admission=AdmissionController(SLOModel(max_delay_steps=96.0)),
        autotier=dict(near_frac=0.30, epoch_steps=16),
        device=DEVICE,
    )
    prof = dataclasses.replace(
        get_profile("Web1"), prompt_mean=32, decode_mean=8, prefix_share=0.9, n_prefixes=3
    )
    gen = RequestGenerator(prof, vocab_size=fleet_vocab(), seed=0)
    stats = fleet.run(gen, n_requests=n_requests, max_steps=800, submit_per_step=2)
    profiles = export_all(fleet.replicas)
    val = validate_fleet(profiles)
    print(f"[{policy}] {N_REPLICAS} replicas, {stats['requests_finished']} finished, "
          f"{stats['shed']} shed")
    print(f"  simulated throughput {stats['simulated_throughput']:.3f} "
          f"(prefill saved {stats['prefill_tokens_saved']}, shared mappings {stats['shared_mappings']})")
    hist = fleet.autotierer.history
    overlap = f"{hist[-1].overlap_prev:.2f}" if hist else "n/a"
    print(f"  near-hit {stats['near_hit_rate']:.3f}  "
          f"autotier epochs {len(hist)} (last overlap {overlap})")
    print(f"  fleet trace: {val['trace_len']} accesses stitched from "
          f"{sum(len(p.windows) for p in profiles)} windows x {N_REPLICAS} hosts; "
          f"hit-ratio err {val['hit_ratio_error']*100:.2f}%, R:W err {val['rw_ratio_error_pct']:+.2f}%")
    rep = fleet_report(profiles)
    print(f"  fleet histogram: top-10% of pages serve {rep['hot'][0.1]*100:.1f}% of traffic "
          f"(zipf alpha {rep['zipf_alpha']:.2f})")
    return stats, val


def serve_multi_tenant(n_requests: int = 24):
    """Two tenants, one fleet: per-tenant SLOs + weighted-fair dispatch."""
    fleet = build_fleet(
        N_REPLICAS,
        policy="prefix-affinity",
        n_pages=N_PAGES,
        trace_window=16,
        trace_period=32,
        admission=AdmissionController(
            SLOModel(max_delay_steps=96.0),
            tenant_slos={"cache": SLOModel(max_delay_steps=8.0)},
        ),
        autotier=dict(near_frac=0.30, epoch_steps=16),
        tenant_weights={"web": 2.0, "cache": 1.0},
        device=DEVICE,
    )
    web = RequestGenerator(
        dataclasses.replace(get_profile("Web1"), prompt_mean=32, decode_mean=8,
                            prefix_share=0.9, n_prefixes=3),
        vocab_size=fleet_vocab(), seed=0, rate=8.0, tenant="web",
    )
    cache = RequestGenerator(
        dataclasses.replace(get_profile("Cache1"), prompt_mean=8, decode_mean=4,
                            prefix_share=0.0),
        vocab_size=fleet_vocab(), seed=1, rate=32.0, tenant="cache",
    )
    reqs = interleave([cache, web], n_requests)
    stats = fleet.run(iter(reqs), n_requests=n_requests, max_steps=800, submit_per_step=2)
    print(f"[multi-tenant] {stats['requests_finished']} finished, {stats['shed']} shed")
    for t, ts in sorted(stats["tenants"].items()):
        print(f"  {t:>6}: finished {ts['requests_finished']:3d}  "
              f"near-hit {ts['near_hit_rate']:.3f}  shed-rate {ts['shed_rate']:.3f}")
    return stats


def serve_straggler_autoscale(trace_path=None):
    """Host 3 runs 4x slow; a burst then scales an elastic fleet up/down.

    The autoscale scenario runs with the flight recorder attached and
    exports (optionally to ``trace_path``) a Perfetto-loadable trace of the
    whole scale cycle — queue/decode spans per request, migrate spans from
    the warm handoff, scale instants on the fleet track."""
    prof = dataclasses.replace(
        get_profile("Web1"), prompt_mean=24, decode_mean=6, prefix_share=0.9, n_prefixes=3
    )
    # straggler: barrier vs event-driven over a fixed 40-unit horizon, with
    # the same offered load per unit virtual time (a lockstep iteration
    # spans 4 units under the 4x straggler, so it gets 4 ticks' arrivals)
    tput = {}
    for lockstep in (True, False):
        fleet = build_fleet(
            N_REPLICAS, policy="least-loaded", speeds=(1, 1, 1, 4), n_pages=N_PAGES,
            trace_window=16, trace_period=32,
            device=DEVICE,
        )
        gen = RequestGenerator(prof, vocab_size=fleet_vocab(), seed=0)
        stats = fleet.run(
            gen, n_requests=60, max_steps=10 if lockstep else 40,
            submit_per_step=8 if lockstep else 2, lockstep=lockstep,
        )
        mode = "lockstep" if lockstep else "event"
        tput[mode] = stats["tokens_decoded"] / max(stats["virtual_time"], 1e-9)
        print(f"[straggler/{mode}] {tput[mode]:.2f} tokens per unit virtual time "
              f"({stats['tokens_decoded']} tokens in {stats['virtual_time']:.0f})")
    print(f"  4x straggler: event-driven wins {tput['event'] / tput['lockstep']:.2f}x "
          f"(the barrier pays max(step_cost) every fleet step)")

    # autoscale: a 6 req/tick burst on 2 replicas, then drain + retire —
    # recorded end to end by the flight recorder
    recorder = FlightRecorder()
    fleet = build_fleet(
        2, policy="least-loaded", n_pages=N_PAGES, trace_window=16, trace_period=32,
        admission=AdmissionController(SLOModel(max_delay_steps=16.0)),
        autotier=dict(near_frac=0.30, epoch_steps=4),
        elastic=dict(min_replicas=2, max_replicas=5, cooldown=3.0,
                     up_shed_rate=0.05, up_backlog_frac=0.6, down_backlog_frac=0.15),
        recorder=recorder,
        device=DEVICE,
    )
    gen = RequestGenerator(prof, vocab_size=fleet_vocab(), seed=0)
    stats = fleet.run(gen, n_requests=60, max_steps=400, submit_per_step=6)
    print(f"[autoscale] {stats['requests_finished']} finished, {stats['shed']} shed; "
          f"scale events:")
    for vtime, action, rid in stats["scale_events"]:
        print(f"  t={vtime:5.1f}  {action:>6}  host {rid}")
    val = validate_fleet(fleet.export_profiles())
    print(f"  stitched trace across the scale cycle (incl. retired hosts): "
          f"hit-ratio err {val['hit_ratio_error']*100:.2f}%, "
          f"R:W err {val['rw_ratio_error_pct']:+.2f}%")
    if trace_path is not None:
        summary = recorder.write(trace_path)
    else:
        summary = recorder.validate()
    print(f"  flight recorder: {summary['spans']} spans / {summary['instants']} "
          f"instants on {summary['tracks']} tracks, schema valid"
          + (f" -> {trace_path}" if trace_path else ""))
    return stats, val


def serve_chaos(n_requests: int = 18):
    """Kill one of three hosts mid-burst, recover with a replacement.

    The crash salvages the dead host's drained books, quarantines the
    undrained remainder as a ``lost_window``, and re-dispatches stranded
    requests — the outcome ledger must come back complete (every admitted
    request completed, shed, or failed-with-reason)."""
    fleet = build_fleet(
        3, policy="least-loaded", n_pages=N_PAGES, trace_window=16, trace_period=32,
        autotier=dict(near_frac=0.30, epoch_steps=8),
        elastic=dict(min_replicas=1, max_replicas=4),
        device=DEVICE,
    )
    chaos = ChaosEngine(
        fleet,
        [FaultEvent(6.0, "crash", rid=1, duration=6.0)],
        dispatch_timeout=8.0, max_retries=3,
    )
    prof = dataclasses.replace(
        get_profile("Web1"), prompt_mean=24, decode_mean=6, prefix_share=0.9, n_prefixes=3
    )
    gen = RequestGenerator(prof, vocab_size=fleet_vocab(), seed=0)
    stats = fleet.run(gen, n_requests=n_requests, max_steps=400, submit_per_step=3)
    print(f"[chaos] {stats['requests_finished']} finished, "
          f"{stats['failovers']} failovers, {stats['requests_retried']} retried, "
          f"{stats['lost_tokens']} decode tokens lost")
    for vtime, action, rid, applied in chaos.log:
        print(f"  t={vtime:5.1f}  {action:>14}  host {rid}" + ("" if applied else "  (no-op)"))
    for w in stats["lost_windows"]:
        print(f"  host {w['rid']} lost_window: {w['steps_undrained']} undrained steps, "
              f"{w['lost_decode_tokens']} decode tokens discarded")
    rep = fleet.outcome_report()
    print(f"  outcome ledger: {rep['outcomes']} (complete={rep['complete']})")
    return stats, rep


def use_device(device) -> torch.device:
    """Every fleet below runs on ``device``; on the card, the fleet's model
    cache holds the reduced model at widths the card's kernels take."""
    global DEVICE
    dev = resolve_device(device)
    DEVICE = str(dev)
    if dev.type == "cuda":
        cfg = card_widths(get_config(ARCH).reduced())
        api = get_model(cfg)
        fleet_pkg._MODEL_CACHE[(ARCH, DEVICE)] = (cfg, api, api.init(0, device=dev))
    return dev


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default=None, help="write the autoscale run's Perfetto trace here")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    trace_path = args.trace
    print(f"fleets on {use_device(args.device)}")
    rr, _ = serve("round-robin")
    print()
    aff, val = serve("prefix-affinity")
    gain = aff["simulated_throughput"] / rr["simulated_throughput"]
    print(f"\nprefix-affinity vs round-robin: {gain:.2f}x simulated throughput")
    assert gain > 1.0, "prefix-affinity must beat round-robin on shared-template traffic"
    assert val["hit_ratio_error"] <= 0.05 and abs(val["rw_ratio_error_pct"]) <= 5.0, val
    print()
    mt = serve_multi_tenant()
    assert set(mt["tenants"]) == {"web", "cache"}, mt["tenants"]
    print()
    sa, sval = serve_straggler_autoscale(trace_path)
    assert any(e[1] == "up" for e in sa["scale_events"]), sa["scale_events"]
    assert sval["hit_ratio_error"] <= 0.05 and abs(sval["rw_ratio_error_pct"]) <= 5.0, sval
    print()
    cs, crep = serve_chaos()
    assert cs["failovers"] >= 1 and crep["complete"], (cs["failovers"], crep)
    print("serve_fleet ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
