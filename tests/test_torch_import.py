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
        "import repro_torch.fleet, repro_torch.core.tiering\n"
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
                "models.mamba2", "models.zamba2", "models.moe", "runtime.sharded"):
        assert f"repro_torch.{mod}" in mods, mod
    assert [m for m in mods if _is_reference(m)] == []


def test_no_reference_import_in_source():
    """An AST scan of chip_smoke.py and every module of the port, lazy
    imports inside functions included."""
    paths = [ROOT / "chip_smoke.py", *sorted((ROOT / "src" / "repro_torch").rglob("*.py"))]
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
    "data/requests.py", "obs/__init__.py", "obs/metrics.py", "obs/spans.py", "obs/export.py",
    "core/tiering.py", "fleet/scheduler.py", "fleet/replica.py", "fleet/admission.py",
    "fleet/aggregator.py", "fleet/autotier.py", "fleet/faults.py",
]

# The port's fleet modules that are not plain copies: each change to the
# reference's code, as (reference snippet, port snippet). Docstrings and
# comments may differ; the code must be the reference's with exactly these
# replacements (and the package renamed in imports).
CHANGED = {
    "fleet/router.py": [
        # the serving tiers' relative constants under a name without the TPU
        ("from repro.core.hw import TPU_TIERED", "from repro.core.hw import SERVING_TIERED"),
        ("TPU_TIERED[1].latency_rel", "SERVING_TIERED[1].latency_rel"),
    ],
    "fleet/elastic.py": [
        # checkpoint restore is not ported (ROADMAP A9): raise, import nothing
        ("""    from repro.runtime.elastic import elastic_restore

    def source():
        state, _extras = elastic_restore(manager, template, mesh, specs=specs, step=step)
        return state

    return source
""", """    raise NotImplementedError("restoring a serving checkpoint (restored_params_source) is ROADMAP A9")
"""),
    ],
    "fleet/__init__.py": [
        # no JAX: the device every replica runs on
        ("import jax\n\n", "from repro.device import resolve_device\n"),
        ("    recorder=None,\n    **engine_kwargs,", "    recorder=None,\n    device=None,\n    **engine_kwargs,"),
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
         "eng = ShardedServingEngine(api, p, ecfg, seed=seed + rid, device=dev)"),
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
    from repro_torch.configs import get_config
    from repro_torch.models.api import get_model

    for arch in ("qwen2-vl-7b", "whisper-base"):
        with pytest.raises(NotImplementedError, match="A8"):
            get_model(get_config(arch))
    for arch in ("smollm-360m", "granite-moe-3b-a800m", "qwen2-moe-a2.7b", "rwkv6-7b", "zamba2-1.2b"):
        assert get_model(get_config(arch)).family in ("dense", "moe", "ssm", "hybrid")
