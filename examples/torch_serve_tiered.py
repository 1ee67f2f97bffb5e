"""Tiered serving demo on the PyTorch port: paged KV + prefix sharing + TPP
placement + prefetch.

Two engines serve the same Web1-like traffic (high shared-prefix rate):
one with the paper's techniques ON, one with sharing off and a cold-only
placement; the deltas are the paper's Table 5 / Fig. 17 story live.

The ON engine runs with ``EngineConfig.device_tiering=True``: every step's
KV page stream runs through the tiered lookup kernel (B1,
``kernels/tiered_gather``) over a device-resident store (near rows f32,
far rows int8 + per-row scales, the dequant fused into the gather), the
near/far hit counters come back from the kernel, and every placement push
moves real rows between the tiers. With ``tiered_identity_scales=True``
the device path is bit-identical to the host-accounted engine: same
tokens, same counters. The engines run on ``--device`` (default: the CUDA
card, where the model's attention and scans also run on their kernels, at
the widths they take, ``models.api.card_widths``); on the CPU every kernel
takes its plain version. The reference's ``examples/serve_tiered.py``
describes the step budget, sharding and chunked prefill that the same
engine carries.

PYTHONPATH=src python examples/torch_serve_tiered.py [--device cpu]
"""
import argparse
import dataclasses

from repro_torch.configs import get_config
from repro_torch.configs.workloads import get_profile
from repro_torch.data.requests import RequestGenerator
from repro_torch.device import resolve_device
from repro_torch.models.api import card_widths, get_model
from repro_torch.runtime.serving import EngineConfig, ServingEngine


def run(share: float, near_frac: float, label: str, n_requests=12, device=False, dev=None):
    cfg = get_config("smollm-360m").reduced()
    if dev.type == "cuda":
        cfg = card_widths(cfg)
    api = get_model(cfg)
    params = api.init(0, device=dev)
    eng = ServingEngine(
        api, params,
        EngineConfig(
            max_batch=4, max_len=96, n_pages=1024, near_frac=near_frac,
            device_tiering=device, tiered_identity_scales=device,
        ),
        device=dev,
    )
    prof = dataclasses.replace(
        get_profile("Web1"), prompt_mean=48, decode_mean=10,
        prefix_share=share, n_prefixes=2,
    )
    gen = RequestGenerator(prof, vocab_size=cfg.vocab_size, seed=0)
    stats = eng.run(gen, n_requests=n_requests, max_steps=5000)
    pt = eng.pagetable.stats()
    print(f"[{label}]")
    print(f"  prefill tokens {stats['prefill_tokens']} (saved {stats['prefill_tokens_saved']} via shared prefixes)")
    print(f"  near-tier hit rate {stats['near_hit_rate']:.3f}  migrations {stats['migrations']}")
    print(f"  page dedup {pt['dedup_ratio']:.2f}x  (shared mappings {pt['shared_mappings']}, COW {pt['cow_copies']})")
    print(f"  prefetch acc {stats['prefetch_accuracy']:.2f} cov {stats['prefetch_coverage']:.2f} "
          f"bw overhead {stats['prefetch_bw_overhead']:.2f}")
    devt = stats["device_tiering"]
    if devt is not None:
        print(f"  device tiering: {devt['near_hits']} near / {devt['far_hits']} far hits counted "
              f"in-kernel, {devt['moved_rows']} rows migrated ({devt['moved_bytes']} B)")
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    on = run(share=0.95, near_frac=0.30,
             label="technique ON  (sharing + 30% near tier, device-executed)", device=True, dev=dev)
    off = run(share=0.0, near_frac=0.05, label="technique OFF (no sharing, 5% near tier)", dev=dev)
    saved = on["prefill_tokens_saved"]
    print(f"\nprefix sharing recovered {saved} prefill tokens; "
          f"near-hit {on['near_hit_rate']:.2f} vs {off['near_hit_rate']:.2f}")
    print("serve_tiered ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
