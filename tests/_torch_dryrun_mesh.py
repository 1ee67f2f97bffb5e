"""The port's side of ``tests/test_torch_dryrun_mesh.py``, in a process of
its own (the dry run's fake process group must not start in a test
worker):

    python tests/_torch_dryrun_mesh.py bytes|walks OUT.json

``bytes``: for every dry-run cell on ``pod1`` and on ``pod2`` (a fake
group of 256, then 512 ranks), rank 0's argument bytes: the step's
parameters, AdamW state and inputs, and a decode cell's cache leaf by
leaf, as ``launch.dryrun.cell_step`` places them, no step walked;
OUT.json maps "mesh/arch/shape" to them.
``walks``: one reduced cell of each family walked on ``pod1``
(``launch.dryrun.walk_cell``, reduced configs at the card's head widths):
whether it walked, its kernel calls and its collectives by kind; OUT.json
maps "arch/shape" to the walk's record."""
import json
import sys
import traceback

from repro_torch.configs import SHAPES, applicable_shapes, get_config, list_archs
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as meshlib
from repro_torch.models.api import card_widths, get_model

WALKS = [("qwen1.5-110b", "train_4k"),       # dense, pooled 16, sp_activations
         ("granite-moe-3b-a800m", "decode_32k"),  # moe
         ("rwkv6-7b", "long_500k"),         # ssm, pooled 4
         ("zamba2-1.2b", "train_4k"),       # hybrid
         ("qwen2-vl-7b", "prefill_32k"),    # vlm
         ("whisper-base", "train_4k")]      # audio


def _parts(args, kind: str) -> dict:
    """A cell's argument bytes as the reference's side sums them: the
    parameters, the optimizer state, the inputs, and a decode cell's cache
    leaf by leaf."""
    n = dryrun.argument_bytes
    if kind == "train":
        params, state, batch = args
        return {"params": n(params), "state": n(state), "inputs": n(batch)}
    if kind == "prefill":
        params, batch = args
        return {"params": n(params), "state": 0, "inputs": n(batch)}
    params, cache, tokens = args
    return {"params": n(params), "state": 0, "inputs": n(tokens), "cache": {k: n(v) for k, v in cache.items()}}


def argument_bytes() -> dict:
    out = {}
    for mesh in ("single", "multi"):
        with meshlib.fake_process_group(dryrun.CHIPS[mesh]):
            for arch in list_archs():
                for shape in applicable_shapes(get_config(arch)):
                    cfg = dryrun.cell_config(arch, shape, mesh)
                    dmesh, pool = dryrun.production_mesh(cfg, mesh)
                    _, args = dryrun.cell_step(get_model(cfg), shape, dmesh, pool)
                    out[f"{dryrun.MESHES[mesh]}/{arch}/{shape}"] = _parts(args, SHAPES[shape].kind)
    return out


def walks() -> dict:
    out = {}
    with meshlib.fake_process_group(dryrun.CHIPS["single"]):
        for arch, shape in WALKS:
            cfg = card_widths(dryrun.cell_config(arch, shape, "single").reduced())
            rec = {"ok": False}
            try:
                dmesh, pool = dryrun.production_mesh(cfg, "single")
                _, cost, *_ = dryrun.walk_cell(get_model(cfg), shape, dmesh, pool)
                rec = {"ok": True, "pool": pool, "kernel_calls": dict(cost.kernel_calls),
                       "collective_ops": dict(cost.collective_ops), "peak_bytes": cost.peak_bytes,
                       "grad_accum": cfg.grad_accum}
            except Exception:  # noqa: BLE001 - the test reports it
                rec["error"] = traceback.format_exc()
            out[f"{arch}/{shape}"] = rec
    return out


def main():
    out = {"bytes": argument_bytes, "walks": walks}[sys.argv[1]]()
    with open(sys.argv[2], "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
