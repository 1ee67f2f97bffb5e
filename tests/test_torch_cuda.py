"""The Hopper kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where no CUDA device is visible (a CUDA kernel
has no CPU mode), and run on a machine with the card by

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because the shared conftest imports JAX, which that
machine need not have). Rows and counters must be bit-exact; the shapes
cover the scalar tail (widths that are not a multiple of 16 bytes), empty,
duplicate and out-of-range ids, all-near and all-far maps, and bf16 near.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.kernels.tiered_gather import ops, ref

    return ops, ref


def _store(seed, d, kind, near_dtype, n_pages=96, n=77):
    rng = np.random.default_rng(seed)
    cap = n_pages if kind == "all_near" else 30
    tier = np.ones(n_pages, np.int32)
    slot = np.arange(n_pages, dtype=np.int32)
    if kind != "all_far":
        near = rng.choice(n_pages, cap, replace=False)
        tier[near], slot[near] = 0, rng.permutation(cap)
    n = 0 if kind == "empty" else n
    ids = rng.integers(-2, n_pages + 2, n) if kind == "out_of_range" else rng.integers(0, n_pages, n)
    if kind == "dup":
        ids = rng.choice(ids[:3], n)
    cuda = lambda a, dt: torch.as_tensor(a).to(dt).cuda()
    return {
        "hot": cuda(rng.standard_normal((cap, d)), near_dtype),
        "cold_q": cuda(rng.integers(-127, 128, (n_pages, d)), torch.int8),
        "cold_scales": cuda(rng.uniform(1e-3, 1e-1, n_pages), torch.float32),
        "tier": cuda(tier, torch.int32),
        "slot": cuda(slot, torch.int32),
        "ids": cuda(ids, torch.int32),
        "seg_of": cuda(np.sort(rng.integers(-1, 6, n)), torch.int32),  # -1: dropped
    }


@pytest.mark.parametrize("kind", ["mixed", "dup", "empty", "all_near", "all_far", "out_of_range"])
@pytest.mark.parametrize("d", [24, 64, 20480])
@pytest.mark.parametrize("near_dtype", [torch.float32, torch.bfloat16])
def test_tiered_kernels_bit_exact(card, near_dtype, d, kind):
    ops, ref = card
    x = _store(0, d, kind, near_dtype)
    store = [x[k] for k in ("hot", "cold_q", "cold_scales", "tier", "slot", "ids")]
    before = dict(ops.LAUNCHES)
    rows_k, hits_k = ops.tiered_lookup_segments(*store, x["seg_of"], 6)
    rows_p, hits_p = ref.tiered_lookup_segments_ref(*store, x["seg_of"], 6)
    rk, nk, fk = ops.tiered_lookup_counted(*store)
    rp, np_, fp = ref.tiered_lookup_counted_ref(*store)
    torch.cuda.synchronize()
    assert torch.equal(rows_k, rows_p) and torch.equal(hits_k, hits_p)
    assert torch.equal(rk, rp) and int(nk) == int(np_) and int(fk) == int(fp)
    launched = 0 if kind == "empty" else 1
    assert ops.LAUNCHES["tiered_segmented"] - before["tiered_segmented"] == launched
    assert ops.LAUNCHES["tiered_gather"] - before["tiered_gather"] == launched


@pytest.mark.parametrize("src_dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("d", [24, 20480])
def test_gather_rows_bit_exact(card, src_dtype, scaled, d):
    ops, ref = card
    g = torch.Generator().manual_seed(1)
    src = (torch.randn(50, d, generator=g) * 40).to(src_dtype).cuda()
    ids = torch.randint(-3, 53, (33,), generator=g, dtype=torch.int32).cuda()
    scales = torch.rand(50, generator=g).cuda() if scaled else None
    out_k, out_p = ops.gather_rows(src, ids, scales), ref.gather_rows_ref(src, ids, scales)
    torch.cuda.synchronize()
    assert torch.equal(out_k, out_p)


def test_wrapper_refuses_non_contiguous(card):
    ops, _ = card
    x = _store(0, 64, "mixed", torch.float32)
    hot = torch.cat([x["hot"], x["hot"]], dim=1)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        ops.tiered_lookup_counted(hot, *(x[k] for k in ("cold_q", "cold_scales", "tier", "slot", "ids")))


def test_reduced_engine_on_card_equals_cpu(card):
    """The whole device-tiered engine at reduced size: the card (kernels) and
    the CPU (plain versions) give the same books. The books follow the
    schedule, not the token values, so an argmax near-tie that the other
    summation order flips cannot change them."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.workloads import get_profile
    from repro_torch.data.requests import RequestGenerator
    from repro_torch.models.api import get_model
    from repro_torch.runtime.serving import EngineConfig, ServingEngine

    cfg = get_config("smollm-360m").reduced()
    api = get_model(cfg)
    prof = dataclasses.replace(get_profile("Web1"), prompt_mean=24, decode_mean=8,
                               prefix_share=0.5, n_prefixes=2)
    books = {}
    for where in ("cuda", "cpu"):
        eng = ServingEngine(api, api.init(0, device=where), EngineConfig(
            max_batch=4, max_len=64, n_pages=256, near_frac=0.02, placement_window=4,
            device_tiering=True, tiered_identity_scales=True, tiered_verify=True,
        ), seed=0, device=where)
        eng.run(RequestGenerator(prof, vocab_size=cfg.vocab_size, seed=0), n_requests=6)
        books[where] = (eng.live_counters(), eng.stats()["device_tiering"])
    assert books["cuda"] == books["cpu"]
    assert books["cuda"][1]["max_read_error"] == 0.0
