"""Render the dry-run JSON artifacts into markdown tables (mirrors
repro/launch/report.py).

PYTHONPATH=src python -m repro_torch.launch.report [--dir experiments/dryrun_torch]
Prints §Dry-run (memory/fit/collective schedule) and §Roofline (three terms,
bound, useful ratio) markdown tables from the per-cell JSONs that
``launch/dryrun.py`` writes.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

GIB = 2**30
# the mesh directories dryrun writes, and their headings (the card of each)
MESHES = {"h100x1": "1 × NVIDIA H100 80GB HBM3, 700 W", "pod1": "16×16 = 256 × NVIDIA H100 80GB HBM3, 700 W",
          "pod2": "2×16×16 = 512 × NVIDIA H100 80GB HBM3, 700 W"}


def load(dirpath):
    cells = []
    for path in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(path) as f:
            cells.append(json.load(f))
    return cells


def dryrun_table(cells):
    out = [
        "| arch | shape | pool | lower/compile s | peak GiB | fits | collectives (ops: AG/AR/RS/A2A/CP) |",
        "|---|---|---|---|---|---|---|",
    ]
    for c in cells:
        if not c["ok"]:
            out.append(f"| {c['arch']} | {c['shape']} | - | - | - | **FAILED** | {c['error'].splitlines()[0][:60]} |")
            continue
        m = c["memory"]
        ops = c["collectives"]["op_counts"]
        sched = "/".join(
            str(ops.get(k, 0))
            for k in ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
        )
        out.append(
            f"| {c['arch']} | {c['shape']} | {c['pooled'] or '-'} "
            f"| {c['seconds_lower']:.1f}/{c['seconds_compile']:.1f} "
            f"| {m['peak_bytes']/GIB:.2f} | {'yes' if m['fits'] else '**NO**'} | {sched} |"
        )
    return "\n".join(out)


def roofline_table(cells):
    out = [
        "| arch | shape | compute ms | memory ms (kernel-adj) | raw mem ms | collective ms | bound | useful | roofline frac |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for c in cells:
        if not c["ok"] or not c.get("roofline"):
            continue
        r = c["roofline"]
        out.append(
            f"| {c['arch']} | {c['shape']} "
            f"| {r['compute_s']*1e3:.1f} | {r['memory_kernel_adj_s']*1e3:.1f} | {r['memory_s']*1e3:.1f} "
            f"| {r['collective_s']*1e3:.1f} | {r['bound']} | {r['useful_ratio']:.3f} "
            f"| {r['roofline_fraction']:.3f} |"
        )
    return "\n".join(out)


def summary(cells):
    ok = [c for c in cells if c["ok"]]
    fit = [c for c in ok if c["memory"]["fits"]]
    worst = sorted(
        (c for c in ok if c.get("roofline")),
        key=lambda c: c["roofline"]["roofline_fraction"],
    )
    lines = [
        f"cells: {len(cells)}, compiled ok: {len(ok)}, fit HBM: {len(fit)}",
    ]
    if worst:
        lines.append(
            "worst roofline fraction: "
            + ", ".join(f"{c['arch']}x{c['shape']}={c['roofline']['roofline_fraction']:.3f}" for c in worst[:3])
        )
        coll = sorted(ok, key=lambda c: -c["roofline"]["collective_s"])
        lines.append(
            "most collective-bound: "
            + ", ".join(f"{c['arch']}x{c['shape']}={c['roofline']['collective_s']*1e3:.0f}ms" for c in coll[:3])
        )
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    for mesh in MESHES:
        d = os.path.join(args.dir, mesh)
        if not os.path.isdir(d):
            continue
        cells = load(d)
        print(f"\n## Dry-run — {mesh} ({MESHES[mesh]})\n")
        print(dryrun_table(cells))
        print(f"\n## Roofline — {mesh}\n")
        print(roofline_table(cells))
        print(f"\n{summary(cells)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
