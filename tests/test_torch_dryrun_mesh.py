"""The dry run over the reference's production meshes (``launch.dryrun
--mesh single|multi|both``), on the CPU.

1. Argument bytes: for every cell of all 10 archs (every applicable
   shape) on ``pod1`` (16 x 16 = 256 cards) and ``pod2`` (2 x 16 x 16 =
   512), rank 0's bytes of the step's parameters, AdamW state and inputs,
   as ``launch.dryrun.cell_step`` places them in a fake process group
   (``tests/_torch_dryrun_mesh.py``, subprocesses, its two parts side by
   side: the fake group never starts in a test worker), equal the
   reference's per device: the sum of each leaf's
   ``NamedSharding.shard_shape`` over ``_fit_spec``'s specs
   (``tests/_jax_dryrun_bytes.py``, a JAX subprocess under
   ``--xla_force_host_platform_device_count=512``, nothing lowered or
   compiled). Bit for bit, so the placements are the reference's leaf for
   leaf: pooling (qwen1.5-110b 16, qwen2-moe-a2.7b 4, rwkv6-7b 4, for
   every kind of cell), bf16 serving parameters, the batch of 1 held
   whole. A decode cell walks the cache the engine holds
   (``init_cache(mesh=)``), compared leaf by leaf: equal, but for a KV
   leaf whose heads the model axis does not divide, which the reference
   splits over the sequence (where 16 divides it) and the engine holds
   with every head, 16 times the reference's.
2. One reduced cell a family walked on ``pod1`` (card head widths): each
   walks; a train cell's kernel calls are ``api.train_kernel_launches`` a
   rank; the pooled train cell gathers (all-gather) and reduce-scatters,
   and the model-split products reduce (all-reduce).
3. ``--mesh`` takes the reference's choices and the one card's.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.configs import applicable_shapes, get_config, list_archs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import MODEL  # noqa: E402
from repro_torch.models.api import _PORTED, card_widths, get_model, train_kernel_launches  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MODEL_AXIS = 16  # the production meshes' model axis
CELLS = [f"{mesh}/{arch}/{shape}" for mesh in ("pod1", "pod2") for arch in list_archs()
         for shape in applicable_shapes(get_config(arch))]
WALKS = ["qwen1.5-110b/train_4k", "granite-moe-3b-a800m/decode_32k", "rwkv6-7b/long_500k",
         "zamba2-1.2b/train_4k", "qwen2-vl-7b/prefill_32k", "whisper-base/train_4k"]


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """(the reference's bytes, the port's {"bytes", "walks"})."""
    tmp = tmp_path_factory.mktemp("dryrun_mesh")
    path = os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")])
    ref = subprocess.Popen([sys.executable, str(ROOT / "tests" / "_jax_dryrun_bytes.py"), str(tmp / "ref.json")],
                           env=dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=512",
                                    JAX_PLATFORMS="cpu", PYTHONPATH=path),
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    port = {mode: subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_dryrun_mesh.py"), mode,
                                    str(tmp / f"{mode}.json")], env=dict(os.environ, PYTHONPATH=path,
                                                                         OMP_NUM_THREADS="1"),
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for mode in ("bytes", "walks")}
    try:
        for proc in (ref, *port.values()):
            log = proc.communicate(timeout=300)[0]
            assert proc.returncode == 0, log[-4000:]
    finally:
        for proc in (ref, *port.values()):
            if proc.poll() is None:
                proc.kill()
    return json.loads((tmp / "ref.json").read_text()), {mode: json.loads((tmp / f"{mode}.json").read_text())
                                                         for mode in port}


def test_every_cell_is_placed(sides):
    ref, port = sides
    assert sorted(ref) == sorted(port["bytes"]) == sorted(CELLS) and len(CELLS) == 64


@pytest.mark.parametrize("cell", CELLS)
def test_argument_bytes_equal_the_reference(sides, cell):
    ref, port = sides
    got, want = port["bytes"][cell], ref[cell]
    parts = ("params", "state", "inputs")
    assert {k: got[k] for k in parts} == {k: want[k] for k in parts} and got["params"] > 0, (got, want)
    assert ("cache" in got) == ("cache" in want)
    if "cache" in want:  # the engine's cache: every head of a leaf whose sequence the reference splits
        _, arch, shape = cell.split("/")
        cfg = dryrun.cell_config(arch, shape, "single")
        full = get_model(cfg).input_specs(shape)["cache"]
        heads = _PORTED[cfg.family].cache_specs(cfg, 1)
        split = {k for k, spec in _PORTED[cfg.family].cache_specs(cfg).items()  # the sequence, where it divides
                 if spec != heads[k] and full[k].shape[spec.index(MODEL)] % MODEL_AXIS == 0}
        assert sorted(got["cache"]) == sorted(want["cache"])
        assert {k: n // (MODEL_AXIS if k in split else 1) for k, n in got["cache"].items()} == want["cache"], split


@pytest.mark.parametrize("cell", WALKS)
def test_a_reduced_cell_walks_on_pod1(sides, cell):
    rec = sides[1]["walks"][cell]
    assert rec["ok"], rec.get("error")
    arch, shape = cell.split("/")
    if shape == "train_4k":
        cfg = card_widths(get_config(arch).reduced())
        want = {k: v for k, v in train_kernel_launches(cfg, rec["grad_accum"]).items() if v}
        assert rec["kernel_calls"] == want
    else:
        assert sum(rec["kernel_calls"].values()) > 0
    if rec["pool"]:
        assert rec["pool"] == get_config(arch).pooling_cluster
    if cell == "qwen1.5-110b/train_4k":  # pooled: gathered at use, gradients reduce-scattered
        assert rec["collective_ops"].get("all-gather", 0) > 0 and rec["collective_ops"].get("reduce-scatter", 0) > 0
    assert rec["collective_ops"].get("all-reduce", 0) > 0  # the model-split products' partial sums


def test_mesh_choices_are_the_reference_s_and_the_card_s():
    assert dryrun.CHOICES == {"card": ("card",), "single": ("single",), "multi": ("multi",),
                              "both": ("single", "multi")}
    assert [dryrun.MESHES[m] for m in ("card", "single", "multi")] == ["h100x1", "pod1", "pod2"]
    assert [dryrun.CHIPS[m] for m in ("card", "single", "multi")] == [1, 256, 512]
    with pytest.raises(SystemExit):
        dryrun.main(["--mesh", "pod3", "--list"])
