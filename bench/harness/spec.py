"""A cell, found by name from files alone: ``BENCHMARK.json`` names the
cell's configuration and traffic mix, ``bench/configs/<config>.json`` holds
the configuration, ``bench/traffic/<mix>.json`` the mix, and each per-layer
metric is read by ``bench/metrics/<metric>.py``. A model family brings its
plain reference, ``bench/reference/<family>.py``, and its work (model
FLOPs a token, the kernel launches of a prefill and of a decode step),
``bench/families/<family>.py``. Each is loaded from the cell's checkout by
its path, so a cell of a new family needs only new files."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict  # bench/configs/<config>.json
    traffic: dict  # bench/traffic/<mix>.json
    chips: int
    end_to_end: list  # BENCHMARK.json's entries that this cell reports
    per_layer: list
    root: Path = ROOT  # the checkout the files were read from

    @property
    def family(self) -> str:
        return self.config["port"]["family"]


def _reported(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its files."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((root / "bench" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name, config, traffic, int(w["chips"]),
                [m for m in spec["end_to_end"] if _reported(m, name)],
                [m for m in spec["per_layer"] if _reported(m, name)], root)


def _load(root: Path, folder: str, name: str):
    """The module ``root/bench/<folder>/<name>.py``."""
    path = root / "bench" / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing: a {folder[:-1]} is found by its name")
    mod_spec = importlib.util.spec_from_file_location(f"bench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``bench/metrics/<name>.py``."""
    return _load(root, "metrics", name).read


def reference(family: str, root: Path = ROOT):
    """The plain reference module of ``family``: its ``forward``."""
    return _load(root, "reference", family)


def family_work(family: str, root: Path = ROOT):
    """The work module of ``family``: ``flops_per_token``, ``prefill_calls``
    and ``decode_calls``."""
    return _load(root, "families", family)


def limits(cell: str, root: Path = ROOT) -> dict:
    """The limits of the cell's check (``bench/limits/<cell>.json``)."""
    return json.loads((root / "bench" / "limits" / f"{cell}.json").read_text())["limits"]
