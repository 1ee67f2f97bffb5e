"""The port stands alone: importing it loads neither JAX nor the JAX package,
chip_smoke.py imports neither, and an engine asked for no device wants the card."""
import ast
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
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, check=True, cwd=ROOT)
    mods = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.runtime.serving" in mods and "repro_torch.runtime.graphs" in mods
    assert "repro_torch.kernels.flash_attention.ref" in mods
    assert "repro_torch.kernels.paged_attention.ref" in mods
    for mod in ("kernels.rwkv6_scan.ref", "kernels.mamba2_scan.ref", "models.rwkv6",
                "models.mamba2", "models.zamba2"):
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
]


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

    for arch in ("granite-moe-3b-a800m", "qwen2-vl-7b", "whisper-base"):
        with pytest.raises(NotImplementedError, match="A8"):
            get_model(get_config(arch))
    for arch in ("smollm-360m", "rwkv6-7b", "zamba2-1.2b"):
        assert get_model(get_config(arch)).family in ("dense", "ssm", "hybrid")
