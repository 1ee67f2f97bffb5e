#!/usr/bin/env python3
"""Readings for the check's limits, from the root of a checkout on the card:

    python3 bench/control.py --workload <cell> --seeds 11,12,13 --seconds 10 [--control] [--fault token]

For each seed, in one process: a run of the cell's timed path for
``--seconds`` at the cell's own load, then every number the check can
compare, of the program and, with ``--control``, of the float8 control
(the reference with float8 e4m3 products in the program's place, judged by
the same ``check.judge`` and ``check.correct``). ``--fault token`` plants
a fault in the timed path (``token_fault``: a token altered where it is
made). One JSON line a seed, with ``correct`` of each side under the
cell's limits (a number the cell does not compare has no limit). The lower
reading of a limit is the largest the program's seeds give; its upper
reading the smallest the control's give.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
NUMBERS = ("logit_gap", "logits_err", "decode_err", "kv_rows", "books")  # every number the check can compare


@contextlib.contextmanager
def token_fault():
    """A planted fault: every decode alters one row's token where it is
    produced (its logits rolled by one id), the rows in turn by a counter on
    the device, so a captured decode graph alters them too."""
    import torch
    from repro_torch.models.api import ModelAPI

    orig = ModelAPI.decode
    counters = {}

    def decode(self, params, cache, tokens, *, page_size=16, active=None):
        logits, new = orig(self, params, cache, tokens, page_size=page_size, active=active)
        b = logits.shape[0]
        ctr = counters.setdefault(logits.device, torch.zeros((), dtype=torch.int64, device=logits.device))
        row = (torch.arange(b, device=logits.device) == ctr % b)[:, None, None]
        ctr.add_(1)
        return torch.where(row, logits.roll(1, dims=-1), logits), new

    ModelAPI.decode = decode
    try:
        yield
    finally:
        ModelAPI.decode = orig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=("token",))
    args = ap.parse_args(argv)
    cache = ROOT / "bench" / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from bench.harness import spec
    from bench.harness.cell import execute
    from bench.reference.common import Precision

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.load_cell(args.workload)
    cell_limits = spec.limits(cell.name, cell.root)
    limits = {name: cell_limits.get(name, float("inf")) for name in NUMBERS}
    t0 = time.perf_counter()
    with token_fault() if args.fault == "token" else contextlib.nullcontext():
        for seed in (int(s) for s in args.seeds.split(",")):
            out = execute(cell, seed, args.seconds, False, device, lambda: time.perf_counter() - t0,
                          limits=limits, control=Precision("fp8") if args.control else None)
            info = out["info"]
            print(json.dumps({"seed": seed, "fault": args.fault, "correct": out["correct"],
                              "program": {k: v["value"] for k, v in out["check"].items()},
                              "items": info["check_items"], "control": info.get("control"),
                              "served": info["check_served_tokens"], "requests": info["check_requests"],
                              "rows": info["check_rows"], "check_s": info["check_s"],
                              "decode_tok_s": out["metrics"]["decode_tok_s"]["value"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
