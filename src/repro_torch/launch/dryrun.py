"""One-card dry run: walk every (arch x shape) cell on the meta device.

The port's counterpart of the reference's ``launch/dryrun.py``. Nothing is
allocated and no card is needed: parameters, optimizer state, inputs and
caches are meta tensors (``ModelAPI.abstract_params``, ``input_specs``),
and one call of the cell's step runs under the cost walk
(``launch/op_analysis.py``), the kernel wrappers recording their work
instead of launching. Per cell this records, to
``experiments/dryrun_torch/h100x1/<arch>__<shape>.json``:

  * memory     -> the walk's peak live bytes (parameters, AdamW state,
                  inputs, held casts, saved activations) against the card's
                  80 GiB (``core/hw.HBM_BYTES``), and whether the cell fits;
  * cost       -> the walk's flops and bytes (aten ops and kernels);
  * collectives-> by kind (none on one card);
  * the three roofline terms at the H100's figures (``launch/roofline.py``).

A train cell walks ``make_train_step`` with AdamW (the loss, its backward
through the ``autograd.Function``s' plain backwards, the update), a
prefill cell ``make_prefill_step`` and a decode cell ``make_serve_step``
against a cache of the shape's length, the serving cells under
``torch.no_grad()`` with the held casts made by one walk before the
recorded one, as an engine's steady state has them. The cells are the
reference's, at its global batch: most do not fit one card, and the JSON
says so.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                 # 32 cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --list
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Optional

import torch

from repro_torch.configs import SHAPES, applicable_shapes, get_config, list_archs, skipped_shapes
from repro_torch.core import hw
from repro_torch.launch import op_analysis, roofline as rl
from repro_torch.models.api import get_model, make_prefill_step, make_serve_step, make_train_step, trainable
from repro_torch.optim import AdamWConfig, adamw_init

HBM_BUDGET = hw.HBM_BYTES
MESHES = {"single": "h100x1"}  # ROADMAP A11.4 adds the production meshes (pod1, pod2)


@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    ok: bool
    seconds_lower: float = 0.0
    seconds_compile: float = 0.0
    memory: Optional[dict] = None
    cost: Optional[dict] = None
    collectives: Optional[dict] = None
    roofline: Optional[dict] = None
    error: Optional[str] = None
    pooled: int = 0

    def as_dict(self):
        return dataclasses.asdict(self)


def _storages(tensors) -> dict:
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes() for t in tensors}


def walk_cell(api, shape_name: str):
    """(result, Cost, argument bytes, output bytes, aliased output bytes) of
    one step of the cell on meta."""
    sh = SHAPES[shape_name]
    params = api.abstract_params()
    batch = api.input_specs(shape_name)
    if sh.kind == "train":
        named = trainable(params)
        args = (params, adamw_init({n: p.detach() for n, p in named.items()}), batch)
        step = make_train_step(api, AdamWConfig())
    elif sh.kind == "prefill":
        args = (params, batch)
        step = make_prefill_step(api, max_len=sh.seq_len)
    else:
        args = (params, batch["cache"], batch["tokens"])
        step = make_serve_step(api)
    with torch.no_grad() if sh.kind != "train" else torch.enable_grad():
        if sh.kind != "train":
            op_analysis.walk(step, *args)  # the held casts, as an engine's steady state
        held = _storages(op_analysis.held_tensors(args))
        result, cost = op_analysis.walk(step, *args)
    outs = _storages(op_analysis.held_tensors(result))
    return (result, cost, sum(held.values()), sum(outs.values()),
            sum(n for k, n in outs.items() if k in held))


def run_cell(arch: str, shape_name: str, *, interactive_log=print) -> CellResult:
    cfg = get_config(arch)
    sh = SHAPES[shape_name]
    api = get_model(cfg)
    mesh_name = MESHES["single"]
    res = CellResult(arch, shape_name, mesh_name, ok=False)
    t0 = time.time()
    try:
        _, cost, arg_bytes, out_bytes, alias_bytes = walk_cell(api, shape_name)
        res.seconds_lower = time.time() - t0
        res.memory = {
            "argument_bytes": int(arg_bytes),
            "output_bytes": int(out_bytes),
            "temp_bytes": int(cost.peak_bytes - arg_bytes),
            "alias_bytes": int(alias_bytes),
            "peak_bytes": int(cost.peak_bytes),
            "hbm_budget": int(HBM_BUDGET),
        }
        res.memory["fits"] = res.memory["peak_bytes"] <= HBM_BUDGET
        res.cost = {"flops": float(cost.flops), "bytes_accessed": float(cost.bytes),
                    "transcendentals": float(cost.transcendentals), "ops": cost.ops,
                    "kernel_calls": dict(cost.kernel_calls)}
        res.collectives = {
            "total_bytes": float(cost.total_collective_bytes),
            "by_kind_bytes": {k: float(v) for k, v in cost.collective_bytes.items()},
            "op_counts": {k: int(v) for k, v in cost.collective_ops.items()},
            "group_sizes": {k: float(v) for k, v in cost.group_sizes.items()},
        }
        n_tokens = sh.global_batch * (sh.seq_len if sh.kind in ("train", "prefill") else 1)
        terms = rl.roofline(
            cost=cost,
            n_params=float(cfg.n_active_params() if cfg.family == "moe" else cfg.n_params()),
            n_tokens=float(n_tokens),
            kind="train" if sh.kind == "train" else "serve",
        )
        res.roofline = terms.as_dict()
        res.roofline["roofline_fraction"] = rl.roofline_fraction(terms)
        res.ok = True
        interactive_log(
            f"[{mesh_name}] {arch} x {shape_name}: walk {res.seconds_lower:.1f}s "
            f"peak {res.memory['peak_bytes']/2**30:.2f} GiB "
            f"({'fits' if res.memory['fits'] else 'OVER'}) | "
            + rl.format_row("", terms)
        )
    except Exception as e:  # noqa: BLE001 — recorded, the driver continues
        res.seconds_lower = time.time() - t0
        res.error = f"{type(e).__name__}: {e}\n{traceback.format_exc(limit=8)}"
        interactive_log(f"[{mesh_name}] {arch} x {shape_name}: FAILED {type(e).__name__}: {e}")
    return res


def all_cells():
    for arch in list_archs():
        cfg = get_config(arch)
        for shape in applicable_shapes(cfg):
            yield arch, shape


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", action="append", help="arch id (repeatable); default all")
    ap.add_argument("--shape", action="append", help="shape name (repeatable); default all applicable")
    ap.add_argument("--mesh", choices=tuple(MESHES), default="single")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--force", action="store_true", help="recompute cells that already have a JSON")
    args = ap.parse_args(argv)

    cells = [
        (a, s)
        for a, s in all_cells()
        if (not args.arch or a in args.arch) and (not args.shape or s in args.shape)
    ]
    if args.list:
        for a, s in cells:
            print(f"{a:24s} {s}")
        skips = {
            a: skipped_shapes(get_config(a)) for a in list_archs() if skipped_shapes(get_config(a))
        }
        print(f"\n{len(cells)} cells; skips per assignment rules:")
        for a, sk in skips.items():
            for s, why in sk.items():
                print(f"  {a:24s} {s}: {why}")
        return 0

    mesh_dir = os.path.join(args.out, MESHES[args.mesh])
    os.makedirs(mesh_dir, exist_ok=True)
    n_fail = 0
    t0 = time.time()
    for arch, shape in cells:
        path = os.path.join(mesh_dir, f"{arch}__{shape}.json")
        if os.path.exists(path) and not args.force:
            print(f"[skip] {path} exists")
            continue
        res = run_cell(arch, shape)
        with open(path, "w") as f:
            json.dump(res.as_dict(), f, indent=1)
        n_fail += 0 if res.ok else 1
    print(f"done in {time.time() - t0:.1f}s; {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
