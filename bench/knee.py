#!/usr/bin/env python3
"""Sweep an open-loop cell's arrival rate on the card, from the root of a
checkout, to find its knee (the highest rate served without a growing
queue):

    python3 bench/knee.py --workload <cell> --rates 6,8,10,12 --seconds 30 --seed 7

One process, one engine: each rate runs ``--seconds`` of Poisson arrivals
from the cell's mix after the previous rate's requests have drained, and
prints one JSON line: requests sent and finished, the backlog (sent less
finished) at each tenth of the window, the time to first token and the
tokens a second over the window.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    cache = ROOT / "bench" / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from bench.harness import spec

    if not torch.cuda.is_available():
        print("knee: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    if cell.traffic["loop"]["kind"] != "open":
        print("knee: the cell's loop is not open", file=sys.stderr)
        return 2
    for line in sweep(cell, [float(r) for r in args.rates.split(",")], args.seconds, args.seed,
                      torch.device("cuda", 0)):
        print(json.dumps(line), flush=True)
    return 0


def sweep(cell, rates, seconds: float, seed: int, device):
    """Yield one reading a rate (module docstring)."""
    from bench.harness.cell import Driver, _sync, warm_allocator
    from bench.harness.driver import Run, Stamp
    from bench.harness.timeline import end_to_end
    from bench.harness.traffic import Traffic

    run = Run(cell, seed, device)
    warm_allocator(run)
    _sync(device)
    anchor, anchor_host = Stamp(device), time.perf_counter()
    for rate in rates:
        mix = copy.deepcopy(cell.traffic)
        mix["loop"]["rate"] = rate
        made = run.traffic.made
        run.traffic = Traffic(mix, run.cfg.vocab_size, seed + int(rate * 1000))
        run.traffic.made = made
        run.mix = mix
        drv = Driver(run)
        drv.in_window = True
        drv.start()
        t_open = time.perf_counter()
        first = made
        backlog = []
        for tenth in range(1, 11):
            drv.run_until(t_open + seconds * tenth / 10)
            sent = run.traffic.made - first - 1
            done = sum(1 for r in run.reqs.values() if r.rid >= first and r.done_step >= 0)
            backlog.append(sent - done)
        t_close = time.perf_counter()
        while drv.busy():  # drain, arrivals stopped
            run.step()
        _sync(device)
        times = run.times(anchor, anchor_host)
        e2e = end_to_end(times, t_open, t_close)
        yield {"rate": rate, "sent": run.traffic.made - first - 1, "backlog": backlog,
               "decode_tok_s": e2e["decode_tok_s"], "ttft_p50_ms": e2e["ttft_p50_ms"],
               "ttft_p95_ms": e2e["ttft_p95_ms"], "itl_p95_ms": e2e["itl_p95_ms"],
               "late_max_ms": 1e3 * max(drv.lateness) if drv.lateness else None}


if __name__ == "__main__":
    sys.exit(main())
