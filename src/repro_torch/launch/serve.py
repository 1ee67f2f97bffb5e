"""Serving driver: tiered paged-KV engine under a paper-workload profile
(mirrors repro/launch/serve.py).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
      --workload Reader --requests 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m --reduced \
      --workload Reader --requests 16 --device cpu

Prints the engine's MemProf-in-the-loop report: near-tier hit rate, prefix
sharing savings, prefetch accuracy/coverage, and the measured KV bandwidth
distribution (what drives the tier plan). The engine runs on ``--device``
(default: the CUDA card) with device tiering on: every step's KV page
reads go through the tiered lookup (B1) over the device-resident near/far
store, and the model's attention and scans through their kernels on the
card; on the CPU the same engine takes the plain versions.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.configs import get_config
from repro_torch.configs.workloads import PROFILES, get_profile
from repro_torch.core import distribution as dist
from repro_torch.data.requests import RequestGenerator
from repro_torch.device import resolve_device
from repro_torch.models.api import get_model
from repro_torch.runtime.serving import EngineConfig, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--workload", default="Reader", choices=sorted(PROFILES))
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--n-pages", type=int, default=1024)
    ap.add_argument("--near-frac", type=float, default=0.30)
    ap.add_argument("--predictor", default="nextline")
    ap.add_argument("--prompt-mean", type=int, default=32)
    ap.add_argument("--decode-mean", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    api = get_model(cfg)
    dev = resolve_device(args.device)
    params = api.init(0, device=dev)
    eng = ServingEngine(
        api,
        params,
        EngineConfig(
            max_batch=args.max_batch,
            max_len=args.max_len,
            n_pages=args.n_pages,
            near_frac=args.near_frac,
            predictor=args.predictor,
            device_tiering=True,
        ),
        seed=args.seed,
        device=dev,
    )
    prof = dataclasses.replace(
        get_profile(args.workload), prompt_mean=args.prompt_mean, decode_mean=args.decode_mean
    )
    gen = RequestGenerator(prof, vocab_size=cfg.vocab_size, seed=args.seed)
    t0 = time.time()
    stats = eng.run(gen, n_requests=args.requests, max_steps=10_000)
    dt = time.time() - t0

    print(f"[serve] {args.workload} on {args.arch}: {stats['requests_finished']} requests, "
          f"{stats['tokens_decoded']} tokens in {dt:.1f}s ({stats['tokens_decoded']/max(dt,1e-9):.1f} tok/s)")
    for k in ("prefill_tokens", "prefill_tokens_saved", "near_hit_rate", "migrations",
              "prefetch_accuracy", "prefetch_coverage", "prefetch_bw_overhead"):
        v = stats[k]
        print(f"  {k:24s} {v:.3f}" if isinstance(v, float) else f"  {k:24s} {v}")
    counts = eng.profiler.counts("kv")
    if counts.sum():
        cap90 = dist.capacity_for_traffic(counts, 0.9)
        print(f"  kv pages serving 90% BW: {cap90*100:.1f}% of capacity "
              f"(drives the {args.near_frac:.0%} near-tier plan)")
    pt = eng.pagetable.stats()
    print(f"  page table: used={pt['used_pages']} shared={pt['shared_mappings']} "
          f"cow={pt['cow_copies']} dedup={pt['dedup_ratio']:.2f}x")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
