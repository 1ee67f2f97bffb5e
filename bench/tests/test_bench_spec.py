"""The harness finds a cell, its configuration, its mix and its metrics by
name, from files alone, and a new cell needs only new files."""
import json

import pytest
import torch

from bench.harness import spec
from bench.harness.cell import execute
from bench.tests.tiny_cells import make_root


def test_cells_of_the_benchmark_load_by_name():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["engine"]["max_batch"] > 0
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        for m in cell.per_layer:
            assert callable(spec.metric_reader(m["name"]))
        assert set(spec.limits(w["name"])) <= {"logit_gap", "logits_err", "decode_err", "kv_rows", "books"}
        assert {"logit_gap", "logits_err", "decode_err", "kv_rows", "books"} <= set(spec.limits(w["name"]))
        assert spec.reference(cell.family).forward
        work = spec.family_work(cell.family)
        assert work.flops_per_token(cell.config["port"], 0) > 0


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell")
    with pytest.raises(FileNotFoundError):
        spec.family_work("no-such-family")


@pytest.mark.parametrize("name", ["tiny-moe.web1", "tiny-dense.web1"])
def test_a_cell_added_from_new_files_alone_runs(tmp_path, name):
    """A cell of the benchmark's family, and one of a family it does not
    have (its reference and its work new files too), with a new per-layer
    metric: run traced, correct, every metric read."""
    root = make_root(tmp_path)
    (root / "bench" / "metrics" / "tokens_seen.py").write_text(
        "def read(ctx):\n    return float(sum(ctx.run.rows))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "tokens_seen", "unit": "tokens", "better": "higher",
                               "source": "program_counter", "layer": "serving engine (runtime/serving.py)",
                               "moves": "decode_tok_s", "workloads": [name]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell(name, root)
    assert cell.root == root and cell.config["port"]["n_layers"] == 2
    out = execute(cell, 2**31 + 7, 1.0, True, torch.device("cpu"), lambda: 1.0)
    assert out["correct"], out["check"]
    assert out["metrics"]["tokens_seen"]["value"] > 0
    assert out["metrics"]["step_mfu"]["value"] > 0
    assert [m["name"] for m in cell.per_layer if "roofline" in m["name"]] == []  # listed for the real cell only


def test_knee_sweeps_an_open_loop_cell(tmp_path):
    from bench.knee import sweep

    cell = spec.load_cell("tiny-moe.open", make_root(tmp_path))
    lines = list(sweep(cell, [10.0, 20.0], 0.5, 2**31 + 9, torch.device("cpu")))
    assert [x["rate"] for x in lines] == [10.0, 20.0]
    assert all(x["sent"] > 0 and len(x["backlog"]) == 10 for x in lines)
