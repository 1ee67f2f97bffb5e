"""The port stands alone: importing it loads neither JAX nor the JAX package,
chip_smoke.py imports neither, and an engine asked for no device wants the card."""
import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def _is_reference(name: str) -> bool:
    return name == "jax" or name.startswith("jax.") or name == "repro" or name.startswith("repro.")


def test_port_imports_no_jax_and_no_reference_package():
    code = (
        "import json, sys\n"
        "import repro_torch.runtime.serving, repro_torch.runtime.graphs, repro_torch.parity\n"
        "import repro_torch.kernels.tiered_gather.ops\n"
        "import repro_torch.kernels.flash_attention.ops, repro_torch.kernels.paged_attention.ops\n"
        "import repro_torch.kernels.rwkv6_scan.ops, repro_torch.kernels.mamba2_scan.ops\n"
        "import repro_torch.models.rwkv6, repro_torch.models.mamba2, repro_torch.models.zamba2\n"
        "import repro_torch.models.moe, repro_torch.runtime.sharded\n"
        "import repro_torch.models.vlm, repro_torch.models.whisper\n"
        "import repro_torch.fleet, repro_torch.core.tiering\n"
        "import repro_torch.optim, repro_torch.optim.compression\n"
        "import repro_torch.checkpoint.manager, repro_torch.runtime.trainer, repro_torch.runtime.elastic\n"
        "import repro_torch.data.loader, repro_torch.launch.train\n"
        "import repro_torch.launch.serve, repro_torch.launch.report, repro_torch.launch.roofline\n"
        "import repro_torch.launch.op_analysis, repro_torch.launch.dryrun, repro_torch.kernels.work\n"
        "import repro_torch.launch.mesh\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, check=True, cwd=ROOT)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.runtime.serving" in mods and "repro_torch.runtime.graphs" in mods
    assert "repro_torch.kernels.flash_attention.ref" in mods
    assert "repro_torch.kernels.paged_attention.ref" in mods
    assert "repro_torch.fleet.router" in mods and "repro_torch.core.hw" in mods
    for mod in ("kernels.rwkv6_scan.ref", "kernels.mamba2_scan.ref", "models.rwkv6",
                "models.mamba2", "models.zamba2", "models.moe", "runtime.sharded", "models.vlm",
                "models.whisper", "optim.adamw", "optim.schedule", "optim.compression",
                "checkpoint.manager", "runtime.trainer", "runtime.elastic", "data.loader",
                "data.synthetic", "launch.train", "launch.serve", "launch.report", "launch.roofline",
                "launch.op_analysis", "launch.dryrun", "kernels.work", "launch.mesh"):
        assert f"repro_torch.{mod}" in mods, mod
    assert [m for m in mods if _is_reference(m)] == []


def test_no_reference_import_in_source():
    """An AST scan of chip_smoke.py, the torch examples and every module of
    the port, lazy imports inside functions included."""
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    port = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    paths = [ROOT / "chip_smoke.py", *examples, *port]
    scanned = {p.relative_to(ROOT / "src").as_posix() for p in port}
    assert {f"repro_torch/optim/{m}.py" for m in ("__init__", "adamw", "schedule", "compression")} <= scanned
    assert {f"repro_torch/launch/{m}.py" for m in ("serve", "report", "roofline", "op_analysis", "dryrun",
                                                   "mesh")} \
        <= scanned and "repro_torch/kernels/work.py" in scanned
    assert [p.name for p in examples] == [f"torch_{m}.py" for m in ("profile_and_plan", "quickstart", "serve_fleet",
                                                                    "serve_tiered", "train_e2e")]
    found = []
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            found += [(path.name, n) for n in names if _is_reference(n)]
    assert len(paths) > 20 and found == []


COPIED = [
    "env.py", "configs/__init__.py", "configs/base.py", "configs/workloads.py",
    "configs/granite_moe_3b.py", "configs/internlm2_1_8b.py", "configs/qwen1_5_110b.py",
    "configs/qwen2_5_3b.py", "configs/qwen2_moe_a2_7b.py", "configs/qwen2_vl_7b.py",
    "configs/rwkv6_7b.py", "configs/smollm_360m.py", "configs/whisper_base.py",
    "configs/zamba2_1_2b.py", "core/distribution.py", "core/pagetable.py",
    "core/placement.py", "core/profiler.py", "core/memtrace.py", "core/prefetch.py",
    "data/requests.py", "obs/metrics.py", "obs/spans.py", "obs/export.py",
    "core/tiering.py", "fleet/scheduler.py", "fleet/replica.py", "fleet/admission.py",
    "fleet/aggregator.py", "fleet/autotier.py", "fleet/faults.py", "fleet/elastic.py",
    "data/__init__.py", "data/synthetic.py", "data/loader.py", "checkpoint/__init__.py",
    "runtime/__init__.py",
]

# The port's modules that are not plain copies: each change to the
# reference's code, as (reference snippet, port snippet). Docstrings and
# comments may differ; the code must be the reference's with exactly these
# replacements (and the package renamed in imports).
CHANGED = {
    "obs/__init__.py": [
        # the engines' device timelines (obs/timeline.py): kept apart from
        # the registries, written beside the span trace
        ("from repro.obs.spans import Span, SpanRecorder\n",
         "from repro.obs.spans import Span, SpanRecorder\nfrom repro.obs.timeline import DeviceTimeline, trace_events\n"),
        ("        self.extra_registries: List[MetricsRegistry] = []\n",
         "        self.extra_registries: List[MetricsRegistry] = []\n"
         "        self.timelines: List[DeviceTimeline] = []\n"),
        ("""    def register(self, registry: MetricsRegistry):
        \"\"\"Include an engine/replica registry in snapshots and exports.\"\"\"
        if registry is not self.metrics and registry not in self.extra_registries:""",
         """    def register(self, registry):
        if isinstance(registry, DeviceTimeline):
            if registry not in self.timelines:
                self.timelines.append(registry)
        elif registry is not self.metrics and registry not in self.extra_registries:"""),
        ("        export_mod.write_trace(trace_path, events)\n",
         """        export_mod.write_trace(trace_path, events)
        if self.timelines:
            device = trace_events(self.timelines)
            if validate:
                export_mod.validate_trace_events(device)
            export_mod.write_trace(f"{trace_path}.device.json", device)
"""),
    ],
    "fleet/router.py": [
        # the serving tiers' relative constants under a name without the TPU
        ("from repro.core.hw import TPU_TIERED", "from repro.core.hw import SERVING_TIERED"),
        ("TPU_TIERED[1].latency_rel", "SERVING_TIERED[1].latency_rel"),
    ],
    "launch/report.py": [
        # the port's mesh directory and its heading
        ("GIB = 2**30\n", 'GIB = 2**30\nMESHES = {"h100x1": "1 × NVIDIA H100 80GB HBM3, 700 W", '
                          '"pod1": "16×16 = 256 × NVIDIA H100 80GB HBM3, 700 W",\n'
                          '          "pod2": "2×16×16 = 512 × NVIDIA H100 80GB HBM3, 700 W"}\n'),
        ('ap.add_argument("--dir", default="experiments/dryrun")',
         'ap.add_argument("--dir", default="experiments/dryrun_torch")'),
        ('for mesh in ("pod1", "pod2"):', "for mesh in MESHES:"),
        ("""({'16x16=256 chips' if mesh == 'pod1' else '2x16x16=512 chips'})""", "({MESHES[mesh]})"),
    ],
    "launch/serve.py": [
        # the device to serve on (default None: the card), with device tiering on
        ("import jax\n\n", ""),
        ("from repro.data.requests import RequestGenerator\n",
         "from repro.data.requests import RequestGenerator\nfrom repro.device import resolve_device\n"),
        ("""    ap.add_argument("--seed", type=int, default=0)
""", """    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
"""),
        ("    params = api.init(jax.random.PRNGKey(0))",
         "    dev = resolve_device(args.device)\n    params = api.init(0, device=dev)"),
        ("""            predictor=args.predictor,
        ),
        seed=args.seed,
    )""", """            predictor=args.predictor,
            device_tiering=True,
        ),
        seed=args.seed,
        device=dev,
    )"""),
    ],
    "launch/train.py": [
        # the device to train on (default None: the card), handed to the Trainer
        ("""    ap.add_argument("--seed", type=int, default=0)
""", """    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
"""),
        ("""        TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every),
    )""", """        TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every),
        device=args.device,
    )"""),
    ],
    "fleet/__init__.py": [
        # no JAX: the device every replica runs on, and the mesh a replica spans
        ("import jax\n\n", "from repro.device import resolve_device\n"),
        ("    recorder=None,\n    **engine_kwargs,",
         "    recorder=None,\n    device=None,\n    mesh=None,\n    **engine_kwargs,"),
        # the model cache is keyed on (arch, device); the port's init takes a seed
        ("""    if arch not in _MODEL_CACHE:
        cfg = get_config(arch).reduced()
        api = get_model(cfg)
        _MODEL_CACHE[arch] = (cfg, api, api.init(jax.random.PRNGKey(0)))
    cfg, api, params = _MODEL_CACHE[arch]""", """    dev = resolve_device(device)
    key = (arch, str(dev))
    if key not in _MODEL_CACHE:
        cfg = get_config(arch).reduced()
        api = get_model(cfg)
        _MODEL_CACHE[key] = (cfg, api, api.init(0, device=dev))
    cfg, api, params = _MODEL_CACHE[key]"""),
        # every engine, sharded or not, on the fleet's device
        ("eng = ShardedServingEngine(api, p, ecfg, seed=seed + rid)",
         "eng = ShardedServingEngine(api, p, ecfg, seed=seed + rid, device=dev, mesh=mesh)"),
        ("eng = ServingEngine(api, p, ecfg, seed=seed + rid)",
         "eng = ServingEngine(api, p, ecfg, seed=seed + rid, device=dev)"),
        # the vocab comes from the config alone, not the (now per-device) cache
        ("""    if arch in _MODEL_CACHE:
        return _MODEL_CACHE[arch][0].vocab_size
""", ""),
    ],
}


def _code(source: str, package: str) -> str:
    """The module's code as an AST dump: docstrings dropped, and the
    package's own name in import statements normalized."""
    tree = ast.parse(source)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)) and body
                and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        if isinstance(node, ast.ImportFrom) and node.module and node.module.split(".")[0] == package:
            node.module = "PKG" + node.module[len(package):]
    return ast.dump(tree)


def test_copied_modules_keep_the_reference_code():
    """The port's copies of the reference's pure-Python modules are the same
    code: line for line the same text but for ``repro`` -> ``repro_torch``
    in their imports and a few docstring words, and the same AST once
    docstrings are dropped."""
    for rel in COPIED:
        ref = (ROOT / "src" / "repro" / rel).read_text()
        port = (ROOT / "src" / "repro_torch" / rel).read_text()
        assert _code(ref, "repro") == _code(port, "repro_torch"), rel
        assert len(ref.splitlines()) == len(port.splitlines()), rel


def test_changed_modules_differ_only_as_named():
    for rel, changes in CHANGED.items():
        ref = (ROOT / "src" / "repro" / rel).read_text()
        for old, new in changes:
            assert ref.count(old) == 1, (rel, old)
            ref = ref.replace(old, new)
        port = (ROOT / "src" / "repro_torch" / rel).read_text()
        assert _code(ref, "repro") == _code(port, "repro_torch"), rel


def test_hw_holds_the_card_not_the_tpu():
    """The port's hardware model: the card's memory figures, no TPU v5e
    constant, and the reference's tier specs and knee as they are."""
    import repro.core.hw as ref_hw
    import repro_torch.core.hw as hw

    assert (hw.HBM_BW, hw.HOST_LINK_BW) == (3.35e12, 64e9)
    assert not [n for n in vars(hw) if "TPU" in n or n in ("ICI_BW_PER_LINK", "VMEM_BYTES", "DCI_BW")]
    assert "v5e" not in (ROOT / "src" / "repro_torch" / "core" / "hw.py").read_text()
    spec = lambda specs: [dataclasses.astuple(s) for s in specs]
    for name in ("BASELINE", "IDEAL", "TIERED"):
        assert spec(getattr(hw, name)) == spec(getattr(ref_hw, name)), name
    assert (hw.BW_KNEE, hw.GB) == (ref_hw.BW_KNEE, ref_hw.GB)
    rel = lambda specs: [(s.name, s.capacity_frac, s.latency_rel, s.cost_per_unit) for s in specs]
    assert rel(hw.SERVING_TIERED) == rel(ref_hw.TPU_TIERED)


def test_engine_without_device_wants_the_card():
    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model
    from repro_torch.runtime.serving import EngineConfig, ServingEngine

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: device=None resolves to it")
    api = get_model(get_config("smollm-360m").reduced())
    params = api.init(0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(api, params, EngineConfig(max_batch=2, max_len=32, n_pages=64))
    with pytest.raises(RuntimeError, match="CUDA"):
        api.init(0)


def test_unported_family_names_its_roadmap_item():
    """No family is left to port (ROADMAP A8 and A13 are done): every
    config of the port builds through ``get_model``, at full size and
    reduced, and every family has its loss. The model API refuses nothing
    any more: every family trains across cards (A11.6 done), and no ROADMAP
    item is named in it."""
    from repro_torch.configs import get_config, list_archs
    from repro_torch.models import api

    families = set()
    for arch in list_archs():
        for cfg in (get_config(arch), get_config(arch).reduced()):
            families.add(api.get_model(cfg).family)
    assert families == {"dense", "moe", "ssm", "hybrid", "vlm", "audio"} == set(api._PORTED)
    source = (ROOT / "src" / "repro_torch" / "models" / "api.py").read_text()
    raised = [n for n in ast.walk(ast.parse(source))
              if isinstance(n, ast.Raise) and "NotImplementedError" in ast.unparse(n)]
    assert raised == [] and "A8" not in source and "A13" not in source
    assert "A11.3" not in source and "A11.6" not in source


def test_what_the_port_still_refuses_names_a11():
    """No ``NotImplementedError`` is left in the port: training across cards
    (A11.3, and A11.6 for vlm, hybrid and audio), serving every family
    across cards (A11.1, A11.2), the dry run over the production meshes
    (A11.4) and the trainer side (A9) are ported, and no module names an
    item of ROADMAP A11 as still to come."""
    raised = []
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        text = path.read_text()
        for item in ("A11.3", "A11.4", "A11.6"):
            assert item not in text, (path, item)
        for node in ast.walk(ast.parse(text)):
            if isinstance(node, ast.Raise) and "NotImplementedError" in ast.unparse(node):
                raised.append((path.name, ast.unparse(node)))
    assert raised == [], raised


def test_pooling_keeps_the_reference_capacity_model():
    """``core/pooling.py``'s ``apparent_capacity_model`` is the reference's
    code (the same AST once docstrings are dropped)."""
    def fn(rel):
        tree = ast.parse((ROOT / "src" / rel / "core" / "pooling.py").read_text())
        (node,) = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "apparent_capacity_model"]
        return _code(ast.unparse(node), rel)

    assert fn("repro") == fn("repro_torch")


def test_casts_carry_the_gradient_only_in_a_training_forward():
    """``common.cast`` holds one detached cast a leaf for serving; for a leaf
    that requires grad, under grad mode, it casts fresh, holds nothing, and
    the cast carries the gradient back to the f32 leaf. A leaf switched
    back (as the train step does) gets its held cast again, cast anew after
    an in-place update."""
    from repro_torch.models.common import ParamTree, cast

    node = ParamTree(w=torch.linspace(-1, 1, 6))
    held = cast(node, "w", torch.bfloat16)
    assert held.dtype == torch.bfloat16 and not held.requires_grad
    assert cast(node, "w", torch.bfloat16) is held
    node.w.requires_grad_(True)
    with torch.no_grad():
        assert cast(node, "w", torch.bfloat16) is held  # serving under no_grad: held
    fresh = cast(node, "w", torch.bfloat16)
    assert fresh is not held and fresh.requires_grad and torch.equal(fresh.detach(), held)
    assert cast(node, "w", torch.bfloat16) is not fresh  # nothing held for it
    (g,) = torch.autograd.grad(fresh.float().sum(), node.w)
    assert torch.equal(g, torch.ones(6))
    node.w.requires_grad_(False)
    with torch.no_grad():
        node.w.add_(1.0)  # the train step's in-place update bumps the version
    again = cast(node, "w", torch.bfloat16)
    assert again is not held and torch.equal(again, (node.w + 0).to(torch.bfloat16))
