"""Tiny cells for the CPU tests: the real cell's files with the model and
the engine cut to a size a test run holds, written into a checkout of
their own (``make_root``), so that the harness finds them by name from
files alone. One runs the real cell's closed loop, one the same mix as an
open loop, and one is of a family the benchmark does not have (``dense``),
added with its reference and its work as new files."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from bench.harness import spec

DENSE = Path(__file__).resolve().parent / "dense_family"
TINY_PORT = {
    # every token to every expert, in float32: at this size a router that
    # picks 2 of 8 flips its second expert on near ties (the bfloat16 KV
    # cache is enough), and one flip moves a tiny model's logits by 0.2-0.4
    "moe": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=512, n_experts=4,
                top_k=4, moe_d_ff=64, capacity_factor=1.0, compute_dtype="float32"),
    # computed in bfloat16, as the configurations are
    "dense": dict(family="dense", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512),
}
# the tiny cells' own limits, from their sound runs on the CPU: the faults
# and the float8 control read beyond them
TINY_LIMITS = {"logit_gap": 0.1, "logits_err": 0.03, "decode_err": 0.03, "kv_rows": 0.05, "books": 0}
# tiny cell -> (the real cell it is cut from, its family, an open loop's rate)
TINY = {"tiny-moe.web1": ("granite-moe-3b.web1", "moe", None),
        "tiny-moe.open": ("granite-moe-3b.web1", "moe", 15.0),
        "tiny-dense.web1": ("granite-moe-3b.web1", "dense", None)}


def tiny_files(tiny: str):
    """(config, mix) of the tiny cell ``tiny``, from its real cell's files."""
    real, family, rate = TINY[tiny]
    cell = spec.load_cell(real)
    config, mix = cell.config, cell.traffic
    config["port"].update(TINY_PORT[family], name=tiny.split(".")[0])
    config["name"] = config["port"]["name"]
    mix["profile"].update(prompt_mean=24, decode_mean=6, n_prefixes=4)
    mix["engine"].update(max_batch=4, max_len=64, n_pages=16)
    mix["warmup"] = {"steps": 5, "seconds": 1.0}
    mix["trace"] = {"steps": 4}
    mix["check"] = {"sample_tokens": 24, "sample_requests": 3, "row_captures": 2}
    mix["loop"] = {"kind": "closed", "clients": 4} if rate is None else {"kind": "open", "rate": rate}
    return config, mix


def make_root(tmp: Path) -> Path:
    """A checkout holding the real benchmark plus the tiny cells, each added
    as new files and new entries only."""
    root = tmp / "checkout"
    shutil.copytree(spec.ROOT / "bench", root / "bench", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(DENSE / "reference.py", root / "bench" / "reference" / "dense.py")
    shutil.copy(DENSE / "work.py", root / "bench" / "families" / "dense.py")
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for tiny in TINY:
        config, mix = tiny_files(tiny)
        cname, mname = tiny.split(".")
        (root / "bench" / "configs" / f"{cname}.json").write_text(json.dumps(config))
        (root / "bench" / "traffic" / f"tiny-{mname}.json").write_text(json.dumps(mix))
        (root / "bench" / "limits" / f"{tiny}.json").write_text(json.dumps({"limits": TINY_LIMITS}))
        if cname not in {c["name"] for c in bench["configs"]}:
            bench["configs"].append({"name": cname, "source": "a test's own", "file": f"bench/configs/{cname}.json",
                                     "reduced": ["n_layers", "vocab_size"], "why": "a test's tiny cell"})
        bench["workloads"].append({"name": tiny, "config": cname, "traffic": f"tiny-{mname}", "chips": 1,
                                   "why": "a test's tiny cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
