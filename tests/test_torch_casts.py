"""The models' held weight casts (``models.common.cast``), on the CPU.

Each float leaf is cast to the compute dtype once and held: the held cast
is bit-equal to ``p.to(dtype)`` on every call, follows an in-place load,
and the leaves the reference keeps uncast (zamba2's shared block in
serving) stay the parameters themselves. At bf16 compute a decode through
the held casts gives the same logits and cache as its first call, which
made them.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402

ARCHS = ["smollm-360m", "qwen2.5-3b", "rwkv6-7b", "zamba2-1.2b"]
BF16 = torch.bfloat16


def _bf16_api(arch):
    return get_model(dataclasses.replace(get_config(arch).reduced(), compute_dtype="bfloat16"))


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


@pytest.mark.parametrize("arch", ARCHS)
def test_held_casts_equal_per_call_casts(arch):
    api = _bf16_api(arch)
    model = api.init(0, device="cpu")
    for node in (m for m in model.modules() if isinstance(m, common.ParamTree)):
        held = node.tree(BF16)
        fresh = [p.to(BF16) for _, p in node.named_parameters()]
        got = list(_leaves(held))
        assert len(got) == len(fresh)
        for a, b in zip(got, fresh):
            assert a.dtype == b.dtype and torch.equal(a, b)
        # the second call hands back the same tensors, cast nothing anew
        assert all(a is b for a, b in zip(_leaves(node.tree(BF16)), got))
    head = "embed" if api.cfg.tie_embeddings else "lm_head"
    assert torch.equal(common.cast(model, head, BF16), getattr(model, head).to(BF16))


@pytest.mark.parametrize("arch", ARCHS)
def test_held_casts_follow_an_in_place_load(arch):
    api = _bf16_api(arch)
    model = api.init(0, device="cpu")
    layer = model.layers[0]
    before = list(_leaves(layer.tree(BF16)))
    model.load_state_dict(api.init(1, device="cpu").state_dict())
    after = list(_leaves(layer.tree(BF16)))
    fresh = [p.to(BF16) for _, p in layer.named_parameters()]
    assert all(torch.equal(a, b) for a, b in zip(after, fresh))
    assert any(not torch.equal(a, b) for a, b in zip(after, before))


def test_zamba2_shared_block_stays_uncast():
    """The serving paths use the shared block as stored (f32), the
    recurrent layers cast every float leaf, as the reference does."""
    api = _bf16_api("zamba2-1.2b")
    model = api.init(0, device="cpu")
    shared = model.shared.tree()
    assert all(a is p for a, (_, p) in zip(_leaves(shared), model.shared.named_parameters()))
    assert all(t.dtype == torch.float32 for t in _leaves(shared))
    assert all(t.dtype == BF16 for t in _leaves(model.layers[0].tree(BF16)))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_through_held_casts_repeats_the_first(arch):
    api = _bf16_api(arch)
    model = api.init(0, device="cpu")
    rng = np.random.default_rng(2)
    cache = api.init_cache(2, 16, device="cpu")
    cache["lengths"].copy_(torch.tensor([3, 7], dtype=torch.int32))
    tokens = torch.as_tensor(rng.integers(0, api.cfg.vocab_size, (2, 1)), dtype=torch.int32)
    runs = []
    for _ in range(2):  # the first makes the casts, the second reads them
        c = {k: v.clone() for k, v in cache.items()}
        logits, c = api.decode(model, c, tokens)
        runs.append((logits, c))
    (la, ca), (lb, cb) = runs
    assert torch.equal(la, lb)
    assert all(torch.equal(ca[k], cb[k]) for k in ca)
