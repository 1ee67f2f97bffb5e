"""The paper's method, end to end, on the PyTorch port: MEASURE the
workload's memory behavior, then let the measurements PICK the
memory-subsystem design.

1. profile block accesses (MemProf.MemBW analogue) for a service,
2. compute the bandwidth distribution + stability (Fig. 9/18),
3. plan a two-tier split from the CDF and evaluate Baseline/Ideal/Tiered
   (Table 4/5), and
4. check the prefetchability of the stream (Fig. 21/22).

Steps 1-4 are host-side (numpy), as in the reference's
``examples/profile_and_plan.py``. The port adds the device: the planned
split is then executed on ``--device`` (default: the CUDA card), the
measured stream gathered through the tiered lookup (``kernels/
tiered_gather``, B2 on the card) over a store whose near tier holds the
measured hottest blocks, and the near share the kernel counts must equal
the one the host counts.

PYTHONPATH=src python examples/torch_profile_and_plan.py [--workload Reader] [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.workloads import PROFILES
from repro_torch.core import distribution as dist
from repro_torch.core import hw
from repro_torch.core.prefetch import PrefetchEngine
from repro_torch.core.profiler import AccessProfiler
from repro_torch.core.tiering import ThroughputModel, evaluate_configs
from repro_torch.data.requests import RequestGenerator
from repro_torch.device import resolve_device, to_device, to_host
from repro_torch.kernels.tiered_gather import tiered_lookup_counted

ROW = 16  # f32 values a block's row holds in the device store


def execute_plan(counts: np.ndarray, stream: np.ndarray, near_frac: float, dev: torch.device):
    """Gather ``stream`` through the tiered lookup over a store whose near
    tier holds the ``near_frac`` hottest blocks of ``counts``; returns the
    (near, far) hits the lookup counts and the near hits the host counts."""
    n = counts.size
    near = np.argsort(-counts, kind="stable")[: max(1, int(near_frac * n))]
    tier = np.ones(n, np.int32)
    tier[near] = 0
    slot = np.zeros(n, np.int32)
    slot[tier == 0] = np.arange(int((tier == 0).sum()))
    slot[tier == 1] = np.arange(int((tier == 1).sum()))
    rng = np.random.default_rng(0)
    hot = rng.standard_normal((int((tier == 0).sum()), ROW)).astype(np.float32)
    cold = rng.integers(-127, 128, (int((tier == 1).sum()), ROW)).astype(np.int8)
    scales = np.full(cold.shape[0], 1.0 / 127, np.float32)
    args = [to_device(a, dt, dev) for a, dt in ((hot, torch.float32), (cold, torch.int8),
                                                  (scales, torch.float32), (tier, torch.int32),
                                                  (slot, torch.int32), (stream, torch.int32))]
    _, near_hits, far_hits = tiered_lookup_counted(*args)
    return int(to_host(near_hits)), int(to_host(far_hits)), int((tier[stream] == 0).sum())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="Reader", choices=sorted(PROFILES))
    ap.add_argument("--samples", type=int, default=120_000)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    prof_spec = PROFILES[args.workload]

    # 1. measure
    gen = RequestGenerator(prof_spec, vocab_size=1024, seed=0)
    stream = gen.block_stream(args.samples)
    prof = AccessProfiler(n_blocks=prof_spec.n_blocks)
    prof.record("state", stream)
    counts = prof.counts("state")

    # 2. distribution
    cap90 = dist.capacity_for_traffic(counts, 0.90)
    alpha = dist.zipf_alpha(counts)
    thirds = [np.bincount(t, minlength=prof_spec.n_blocks) for t in np.array_split(stream, 3)]
    stab = dist.interval_stability(thirds, 0.10)
    print(f"[{args.workload}] measured behavior:")
    print(f"  90% of bandwidth comes from {cap90*100:.1f}% of capacity (zipf alpha ~ {alpha:.2f})")
    print(f"  hottest-10% traffic share stable at {stab['mean']:.3f} +- {stab['max_dev']:.3f} across windows")

    # 3. the measurements pick the design
    res = evaluate_configs(
        counts,
        {"Baseline": hw.BASELINE, "Ideal": hw.IDEAL, "Tiered": hw.TIERED},
        ThroughputModel(),
    )
    print("  tier evaluation (paper Table 5):")
    for name, r in res.items():
        print(
            f"    {name:9s} tput {r['relative_throughput']:.3f}x  "
            f"tput/cost {r['throughput_per_cost']:.3f}  bound {r['bound']}"
        )
    best = max(res, key=lambda k: res[k]["throughput_per_cost"])
    print(f"  -> measured behavior selects: {best}")

    # 4. prefetchability
    eng = PrefetchEngine("nextline", buffer_blocks=256, degree=1)
    for b in stream[:20_000]:
        eng.access(int(b), is_far=True)
    s = eng.stats
    print(f"  prefetcher on this stream: accuracy {s.accuracy:.2f}, coverage {s.coverage:.2f} "
          f"(paper Fig. 22: worth enabling only with bandwidth headroom)")

    # the planned split, executed on the device
    near_frac = hw.TIERED[0].capacity_frac
    near_k, far_k, near_host = execute_plan(counts, stream[:20_000], near_frac, dev)
    print(f"  the Tiered split on {dev}: {near_frac:.1%} of blocks near serve "
          f"{near_k / (near_k + far_k):.3f} of the stream's accesses ({near_k} near / {far_k} far "
          f"counted in the lookup; host count {near_host})")
    assert near_k == near_host and near_k + far_k == 20_000, (near_k, far_k, near_host)
    print("profile_and_plan ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
