"""The plain references compute what the port computes: at a tiny size on
the CPU, in float32, the port's prefill logits and cached keys and values
equal the reference's within float32 rounding."""
import numpy as np
import pytest
import torch

from bench.harness import spec
from bench.harness.driver import build_model
from bench.reference.common import Precision
from bench.tests.tiny_cells import make_root, tiny_files

FAMILIES = ["tiny-moe.web1", "tiny-dense.web1"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", FAMILIES)
def test_reference_matches_the_port_in_float32(root, cell):
    config, _ = tiny_files(cell)
    config["port"]["compute_dtype"] = "float32"
    api, params, leaves = build_model(config, 2**31 + 3, torch.device("cpu"))
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, 512, 40), dtype=torch.int64)
    logits, cache = api.prefill(params, {"tokens": tokens[None].to(torch.int32)}, max_len=48)
    forward = spec.reference(config["port"]["family"], root).forward
    ref, k, v = forward(leaves, config["port"], tokens)
    torch.testing.assert_close(logits[0, :, :512], ref, rtol=1e-4, atol=1e-4)
    # the cache holds bfloat16 keys and values, (layers, batch, heads, positions, dim)
    ck = cache["k"][:, 0, :, :40].transpose(1, 2).float()
    cv = cache["v"][:, 0, :, :40].transpose(1, 2).float()
    torch.testing.assert_close(ck, k, rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(cv, v, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("cell", FAMILIES)
def test_fp8_precision_moves_the_reference(root, cell):
    config, _ = tiny_files(cell)
    _, _, leaves = build_model(config, 5, torch.device("cpu"))
    tokens = torch.arange(30) % 512
    forward = spec.reference(config["port"]["family"], root).forward
    a = forward(leaves, config["port"], tokens)[0]
    b = forward(leaves, config["port"], tokens, Precision("fp8"))[0]
    err = (a - b).abs().max() / a.abs().max()
    assert 1e-3 < float(err) < 0.5


def test_fp8_rounding_is_float8_e4m3():
    p = Precision("fp8")
    x = torch.tensor([[1.0, 0.3, -448.0]])
    y = p._round(x, -1)
    assert float(y[0, 2]) == -448.0 and float(y[0, 0]) == 1.0
    assert float(y[0, 1]) != 0.3
    with pytest.raises(ValueError):
        Precision("int3")
