"""Dry run: walk every (arch x shape) cell on the meta device, on one card
or over the reference's production meshes.

The port's counterpart of the reference's ``launch/dryrun.py``. Nothing is
allocated and no card is needed: parameters, optimizer state, inputs and
caches are meta tensors (``ModelAPI.abstract_params``, ``input_specs``),
and one call of the cell's step runs under the cost walk
(``launch/op_analysis.py``), the kernel wrappers recording their work
instead of launching. ``--mesh`` takes the reference's choices: ``single``
walks each cell over ``pod1`` (16 x 16 = 256 cards), ``multi`` over
``pod2`` (2 x 16 x 16 = 512), ``both`` over the two; ``card`` walks it on
one card (``h100x1``). Per cell this records, to
``experiments/dryrun_torch/{h100x1,pod1,pod2}/<arch>__<shape>.json``:

  * memory     -> the walk's peak live bytes (parameters, AdamW state,
                  inputs, held casts, saved activations), per card, against
                  the card's 80 GiB (``core/hw.HBM_BYTES``), and whether
                  the cell fits; ``argument_bytes`` are the step's
                  parameters, optimizer state, inputs and cache (a card's
                  shards of them on a mesh), ``held_bytes`` the casts a
                  serving step holds;
  * cost       -> the walk's flops and bytes (aten ops and kernels), a
                  card's;
  * collectives-> by kind, with op counts and group sizes, and each
                  (kind, group, link) apart;
  * the three roofline terms at the H100's figures (``launch/roofline.py``),
    the collective term at the link each group crosses.

Over a production mesh the walk runs in a fake process group of 256 or 512
ranks in this one process (``launch.mesh.fake_process_group``), as its rank
0, and mirrors the reference's ``run_cell``: ``pool`` is the config's
``pooling_cluster`` where it is above 1 (the mesh then factors data into
(data, pool)), for every kind of cell; a serving cell turns
``sp_activations`` off and takes bf16 parameters at the (pooled) storage
specs, a train cell f32 parameters with AdamW's moments beside them at the
same specs and ``storage_specs`` passed to the step; inputs sit at
``batch_specs`` (every leaf drops a mesh axis that does not divide its
dimension: a batch of 1 over data 16 is held whole), and the train step
gathers them whole before it splits its micro-batches, as it takes any
placed batch. A decode cell's cache is the one the engine holds
(``ModelAPI.init_cache(mesh=)``): this rank's rows, and its share of each
head axis the model axis divides, every head where it does not (where the
reference's ``cache_specs`` split the sequence instead).

A train cell walks ``make_train_step`` with AdamW (the loss, its backward
through the ``autograd.Function``s' plain backwards, the update), a
prefill cell ``make_prefill_step`` and a decode cell ``make_serve_step``
against a cache of the shape's length, the serving cells under
``torch.no_grad()`` with the held casts made by one walk before the
recorded one, as an engine's steady state has them. The cells are the
reference's, at its global batch: most do not fit one card, and the JSON
says so.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                 # 32 cells on pod1
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both     # 64: pod1 and pod2
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh card     # 32 on one card
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --list
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import time
import traceback
from typing import Optional

import torch

import torch.distributed as dist

from repro_torch.configs import SHAPES, applicable_shapes, get_config, list_archs, skipped_shapes
from repro_torch.core import hw, pooling
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import op_analysis, roofline as rl
from repro_torch.models.api import get_model, make_prefill_step, make_serve_step, make_train_step, trainable
from repro_torch.optim import AdamWConfig, adamw_init

HBM_BUDGET = hw.HBM_BYTES
# --mesh choice -> the directory its cells go to, and the cards it spans
MESHES = {"card": "h100x1", "single": "pod1", "multi": "pod2"}
CHIPS = {"card": 1, "single": 256, "multi": 512}
CHOICES = {"card": ("card",), "single": ("single",), "multi": ("multi",), "both": ("single", "multi")}


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


def argument_bytes(args) -> int:
    """The bytes a step's arguments hold on a card: parameters, optimizer
    state, inputs and cache (a DTensor's local shard), each storage once."""
    return sum(_storages(op_analysis.held_tensors(args)).values())


def cell_step(api, shape_name: str, mesh=None, pool: int = 0):
    """(step, args) of one cell on meta: on one card the global shapes; on
    a mesh the reference's placements (module docstring), every leaf a
    DTensor whose local tensor is this rank's shard. ``shape_name``: a
    ``SHAPES`` cell, or a ``ShapeSpec`` of its own."""
    sh = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    params = api.abstract_params()
    batch = api.input_specs(shape_name)
    specs = None
    if mesh is not None:
        if sh.kind != "train":
            params = params.to(torch.bfloat16)  # the reference's serving cells: bf16 parameters
        specs = api.param_specs()
        if pool:
            specs = pooling.pooled_specs(specs, params, mesh)
        params = meshlib.place_params(params, mesh, specs)
        bspecs = api.batch_specs(shape_name)
        batch = {k: meshlib.distribute(v, mesh, bspecs[k]) for k, v in batch.items() if k != "cache"}
        if sh.kind == "decode":  # the engine's cache (``init_cache``): this rank's rows and heads
            batch["cache"] = api.init_cache(meshlib.local(batch["tokens"]).shape[0], sh.seq_len, device="meta",
                                            mesh=mesh)
    if sh.kind == "train":
        named = trainable(params)
        step = make_train_step(api, AdamWConfig(), compute_specs=None if mesh is None else api.param_specs(),
                               storage_specs=specs)
        return step, (params, adamw_init({n: p.detach() for n, p in named.items()}), batch)
    if sh.kind == "prefill":
        return make_prefill_step(api, max_len=sh.seq_len), (params, batch)
    return make_serve_step(api), (params, batch["cache"], batch["tokens"])


def walk_cell(api, shape_name: str, mesh=None, pool: int = 0):
    """(result, Cost, argument bytes, output bytes, aliased output bytes,
    held-cast bytes) of one step of the cell on meta (a card's, on a
    mesh). A serving step is walked once first: the casts it holds are
    there at the recorded walk's start, as in an engine's steady state."""
    sh = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    step, args = cell_step(api, shape_name, mesh, pool)
    arg_bytes = argument_bytes(args)
    with meshlib.activate(mesh), torch.no_grad() if sh.kind != "train" else torch.enable_grad():
        if sh.kind != "train":
            op_analysis.walk(step, *args)  # the held casts, as an engine's steady state
        held = _storages(op_analysis.held_tensors(args))
        result, cost = op_analysis.walk(step, *args)
    outs = _storages(op_analysis.held_tensors(result))
    return (result, cost, arg_bytes, sum(outs.values()),
            sum(n for k, n in outs.items() if k in held), sum(held.values()) - arg_bytes)


def cell_config(arch: str, shape_name: str, mesh: str = "card"):
    """The cell's config: over a production mesh a serving cell turns
    ``sp_activations`` off (a training memory feature), as the
    reference's ``run_cell``."""
    cfg = get_config(arch)
    if mesh != "card" and SHAPES[shape_name].kind != "train" and cfg.sp_activations:
        cfg = dataclasses.replace(cfg, sp_activations=False)
    return cfg


def production_mesh(cfg, mesh: str):
    """(the production mesh of ``mesh`` ("single" or "multi") over the
    running process group, pool): ``pool`` the config's
    ``pooling_cluster`` where it is above 1, else 0."""
    pool = cfg.pooling_cluster if cfg.pooling_cluster > 1 else 0
    return meshlib.make_production_mesh(multi_pod=mesh == "multi", pool=pool), pool


def run_cell(arch: str, shape_name: str, mesh: str = "card", *, interactive_log=print) -> CellResult:
    """One cell on one card (``mesh="card"``) or over a production mesh
    (``"single"``: pod1, ``"multi"``: pod2), in the running process group
    or, with none, in a fake one of the mesh's ranks for this cell."""
    if mesh != "card" and not dist.is_initialized():
        with meshlib.fake_process_group(CHIPS[mesh]):
            return run_cell(arch, shape_name, mesh, interactive_log=interactive_log)
    cfg = cell_config(arch, shape_name, mesh)
    sh = SHAPES[shape_name]
    api = get_model(cfg)
    mesh_name = MESHES[mesh]
    res = CellResult(arch, shape_name, mesh_name, ok=False)
    t0 = time.time()
    try:
        dmesh, pool = production_mesh(cfg, mesh) if mesh != "card" else (None, 0)
        res.pooled = pool
        _, cost, arg_bytes, out_bytes, alias_bytes, held_bytes = walk_cell(api, shape_name, dmesh, pool)
        res.seconds_lower = time.time() - t0
        res.memory = {
            "argument_bytes": int(arg_bytes),
            "held_bytes": int(held_bytes),
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
            "by_group": {k: dict(v) for k, v in cost.collectives.items()},
        }
        n_tokens = sh.global_batch * (sh.seq_len if sh.kind in ("train", "prefill") else 1)
        terms = rl.roofline(
            cost=cost,
            n_params=float(cfg.n_active_params() if cfg.family == "moe" else cfg.n_params()),
            n_tokens=float(n_tokens),
            chips=CHIPS[mesh],
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
    ap.add_argument("--mesh", choices=tuple(CHOICES), default="single",
                    help="single: pod1 (256 cards), multi: pod2 (512), both, or card: one H100")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--force", action="store_true", help="recompute cells that already have a JSON")
    args = ap.parse_args(argv)
    # DTensor warns at every reduction over two or three mesh axes
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)

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

    n_fail = 0
    t0 = time.time()
    for mesh in CHOICES[args.mesh]:
        mesh_dir = os.path.join(args.out, MESHES[mesh])
        os.makedirs(mesh_dir, exist_ok=True)
        todo = [(a, s) for a, s in cells
                if args.force or not os.path.exists(os.path.join(mesh_dir, f"{a}__{s}.json"))]
        for a, s in cells:
            if (a, s) not in todo:
                print(f"[skip] {os.path.join(mesh_dir, f'{a}__{s}.json')} exists")
        group = meshlib.fake_process_group(CHIPS[mesh]) if mesh != "card" and todo else contextlib.nullcontext()
        with group:
            for arch, shape in todo:
                res = run_cell(arch, shape, mesh)
                with open(os.path.join(mesh_dir, f"{arch}__{shape}.json"), "w") as f:
                    json.dump(res.as_dict(), f, indent=1)
                n_fail += 0 if res.ok else 1
    print(f"done in {time.time() - t0:.1f}s; {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
