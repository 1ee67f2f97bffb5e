"""The torch examples (``examples/torch_*.py``) on the CPU.

Each runs its ``main`` reduced with ``--device cpu`` and prints its win
conditions, the reference example's own (``examples/*.py``) and, for
``torch_profile_and_plan``, the planned split executed through the tiered
lookup with its in-kernel count equal to the host's. Without ``--device``
an example wants the card, as every entry point of the port does.
"""
import importlib
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

CASES = [
    ("torch_quickstart", ["--steps", "4"], ["quickstart ok", "prompt+decode ids"]),
    ("torch_quickstart", ["--arch", "zamba2-1.2b", "--steps", "2"], ["quickstart ok"]),
    ("torch_serve_tiered", [], ["serve_tiered ok", "device tiering: 559 near / 0 far hits",
                                "prefix sharing recovered 224 prefill tokens"]),
    ("torch_profile_and_plan", [], ["profile_and_plan ok", "measured behavior selects: Tiered",
                                    "counted in the lookup"]),
    ("torch_train_e2e", ["--steps", "60", "--d-model", "64", "--n-layers", "2", "--vocab", "512", "--seq", "32",
                         "--batch", "4"], ["train_e2e ok", "resumed at step 25"]),
    ("torch_serve_fleet", [], ["serve_fleet ok", "prefix-affinity vs round-robin",
                               "outcome ledger: {'completed': 18} (complete=True)"]),
]


@pytest.fixture(scope="module")
def example():
    """The examples as modules, run with one intra-op thread: their reduced
    models' ops are tiny, and several threads a worker only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        yield importlib.import_module
    finally:
        sys.path.remove(str(ROOT / "examples"))
        torch.set_num_threads(threads)


@pytest.mark.parametrize("name,argv,wins", CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_example_runs_on_the_cpu(example, name, argv, wins, capsys):
    assert example(name).main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for win in wins:
        assert win in out, (win, out[-2000:])


def test_examples_without_device_want_the_card(example):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: device=None resolves to it")
    for name in ("torch_quickstart", "torch_serve_tiered", "torch_profile_and_plan", "torch_train_e2e",
                 "torch_serve_fleet"):
        with pytest.raises(RuntimeError, match="CUDA"):
            example(name).main([])
