"""The five readers of the engine's device timeline each read a positive
number in a traced run of a tiny cell, and read nothing (None, no raise)
from an engine that has no timeline."""
import json
from types import SimpleNamespace

import pytest
import torch

from bench.harness import spec
from bench.harness.cell import execute
from bench.tests.tiny_cells import make_root

READERS = ["queue_wait_ms", "prefill_model_ms", "tier_lookup_span_ms", "host_stall_ms", "tier_epoch_ms"]


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """One traced run of ``tiny-moe.web1``, with ``prefill_model_ms`` (listed
    for the real cell alone) listed for it too, and warmed up to just short
    of the engine's first placement-window boundary (16 steps), so that the
    window holds one."""
    root = make_root(tmp_path_factory.mktemp("timeline"))
    mix_file = root / "bench" / "traffic" / "tiny-web1.json"
    mix = json.loads(mix_file.read_text())
    mix["warmup"]["steps"] = 14
    mix_file.write_text(json.dumps(mix))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] == "prefill_model_ms":
            m["workloads"].append("tiny-moe.web1")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("tiny-moe.web1", root)
    return cell, execute(cell, 2**31 + 11, 2.0, True, torch.device("cpu"), lambda: 1.0)


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_the_timeline(traced, name):
    cell, out = traced
    assert name in {m["name"] for m in cell.per_layer}
    assert out["metrics"][name]["value"] > 0
    assert out["metrics"][name]["unit"] == "ms"


@pytest.mark.parametrize("name", READERS)
def test_reader_of_an_engine_without_a_timeline_reads_nothing(name):
    ctx = SimpleNamespace(run=SimpleNamespace(eng=object()), t_open=0.0, t_close=1.0)
    assert spec.metric_reader(name)(ctx) is None
