#!/usr/bin/env python3
"""Run one cell of the port's serving benchmark on the CUDA card(s) of this
machine, from the root of a checkout:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as its last line on standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``check``: each number the check compared, with its
limit, as the last lines on standard error say too. Exits non-zero, and
prints no result, without a CUDA card (or with fewer than the cell asks
for), or if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # whole top-level module names


def _process_age() -> float:
    """Seconds since this process started (from /proc; the host clock)."""
    ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
    uptime = float(Path("/proc/uptime").read_text().split()[0])
    return uptime - ticks / os.sysconf("SC_CLK_TCK")


def _card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def loaded_forbidden() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _finite(x):
    if isinstance(x, float) and (x != x or x in (float("inf"), float("-inf"))):
        return 1e30
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every cache of the program inside the checkout, at fixed paths
    cache = ROOT / "bench" / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("bench: no program to measure: src/repro_torch is not in this checkout", file=sys.stderr)
        return 2

    import torch

    from bench.harness import spec
    from bench.harness.cell import execute

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = _card()
    out = execute(cell, args.seed, args.seconds, bool(args.trace), device, _process_age)
    found = loaded_forbidden()
    if found:
        print(f"bench: the run loaded {found}: nothing it runs may import JAX or the JAX package",
              file=sys.stderr)
        return 3
    info = out.pop("info")
    info.update(card=card, cell=cell.name, seed=args.seed, trace=args.trace)
    print(json.dumps({"info": _finite(info)}), flush=True)
    check = out.pop("check")
    out["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": cell.chips,
                     **out["device"]}
    out["check"] = check
    for name, n in check.items():
        print(f"check {name}: {n['value']!r} (limit {n['limit']!r})", file=sys.stderr)
    print(json.dumps(_finite(out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
