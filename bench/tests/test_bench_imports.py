"""Nothing a run imports is JAX or the JAX package (top-level names compared
whole: the port's name begins with the JAX package's), and the references
import nothing of the program."""
import ast
import json
import subprocess
import sys

from bench.harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_of_the_harness_imports_jax_or_the_jax_package():
    files = [p for p in (spec.BENCH).rglob("*.py") if "tests" not in p.parts]
    assert len(files) > 20
    for p in files:
        assert not set(_imports(p)) & FORBIDDEN, p
    # nor does a family's reference or its work import anything of the program
    own = [*(spec.BENCH / "reference").glob("*.py"), *(spec.BENCH / "families").glob("*.py"),
           *(spec.BENCH / "tests" / "dense_family").glob("*.py")]
    assert len(own) >= 5
    for p in own:
        assert not set(_imports(p)) & (FORBIDDEN | {"repro_torch"}), p


def test_what_a_run_loads_holds_no_jax():
    code = """
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/src"]
import torch
from bench.harness import spec, cell, check
import bench.run as run
c = spec.load_cell("granite-moe-3b.web1")
for name in json.load(open(sys.argv[1] + "/BENCHMARK.json"))["per_layer"]:
    spec.metric_reader(name["name"])
for fam in ("moe",):
    spec.reference(fam)
    spec.family_work(fam)
from bench.harness.driver import build_model
build_model(c.config | {"port": c.config["port"] | {"n_layers": 1, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
            "d_ff": 32, "vocab_size": 64, "n_experts": 4, "top_k": 2, "moe_d_ff": 32}}, 0, torch.device("cpu"))
import repro_torch.runtime.serving
print(json.dumps(run.loaded_forbidden()))
"""
    out = subprocess.run([sys.executable, "-c", code, str(spec.ROOT)], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
