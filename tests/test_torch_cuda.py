"""The Hopper kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip where no CUDA device is visible (a CUDA kernel
has no CPU mode), and run on a machine with the card by

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because the shared conftest imports JAX, which that
machine need not have). Rows and counters must be bit-exact; the shapes
cover the scalar tail (widths that are not a multiple of 16 bytes), empty,
duplicate and out-of-range ids, all-near and all-far maps, and bf16 near.

The attention kernels compute in f32 like their plain versions and differ
from them only in summation order (bf16 flash takes p into its
tensor-core product as three bf16 parts, all 24 bits of it; f32 flash
takes each product as three TF32 products of split operands, some 21-22
bits): f32 outputs agree to 2e-5, bf16 outputs to one bf16 step (2**-7 of
the value), the final rounding. They cover head_dim 64 and 128, GQA
groups of 1, 3, 7 and 8, ragged lengths, lengths past the cache's end,
causal and non-causal prefill, and whisper's non-causal sites over 1500
keys (one of them, a single query, inside a captured graph); the
redesigned kernels also against the plain versions of their own
algorithms (tiles of 64 keys; spans merged in split order), at one
tile, at 1000 tokens, with q_offset and lk_valid, and at S = 1024, where
paged decode splits over a cluster of 8 blocks.

The scan kernels (WKV6, SSD) take a closed form per chunk where their
plain versions run the recurrence step by step; the per-chunk cumulative
decay rounds an exponent by up to one f32 step of its size, so they are
held to 1e-4 of each value plus 1e-4 of the output's largest magnitude.
They cover hd, P and N of 16 and 64, ragged lengths and one token, zero
and given states, strong decays, in-place state updates and strided
inputs; the SSD prefill at every cluster split it takes against the plain
version of its split algorithm; and the reduced recurrent engines on the
card against the CPU.

The serving engine replays captured CUDA graphs on the card: against the
same engine run eagerly on the card they give bit-equal tokens, caches,
next-step logits, live counters and books, on the whole-slot and the
chunked path of all the families (vlm and audio prefill whole under a
chunk budget); the held weight casts are bit-equal
to per-call casts there; the chunked card engine gives the CPU engine's
books; and a capture that meets a host read raises.
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


def _edge_store(kind, near_dtype):
    """A store for the lookup's edges: negative and out-of-range ids and
    slots, segment ids outside [0, n_seg), and per kind an empty near or
    far store (their rows read as zeros), widths off 16 bytes, one gather."""
    rng = np.random.default_rng(7)
    d = {"unaligned": 13, "unaligned_wide": 20483}.get(kind, 64)
    n = 1 if kind == "one_gather" else 300
    n_pages, n_seg = 50, 5
    near_rows = 0 if kind == "empty_near" else 20
    far_rows = 0 if kind == "empty_far" else 40
    cuda = lambda a, dt: torch.as_tensor(a).to(dt).cuda()
    return {
        "hot": cuda(rng.standard_normal((near_rows, d)), near_dtype),
        "cold_q": cuda(rng.integers(-127, 128, (far_rows, d)), torch.int8),
        "cold_scales": cuda(rng.uniform(1e-3, 1e-1, far_rows), torch.float32),
        "tier": cuda(rng.integers(0, 2, n_pages), torch.int32),
        "slot": cuda(rng.integers(-3, 45, n_pages), torch.int32),
        "ids": cuda(rng.integers(-n_pages - 2, n_pages + 2, n), torch.int32),
        "seg_of": cuda(rng.integers(-2, n_seg + 2, n), torch.int32),
        "n_seg": n_seg,
    }


@pytest.mark.parametrize("kind", ["main", "empty_near", "empty_far", "unaligned", "unaligned_wide",
                                  "one_gather"])
@pytest.mark.parametrize("near_dtype", [torch.float32, torch.bfloat16])
def test_tiered_lookup_edges_bit_exact(card, near_dtype, kind):
    """B1 (segments) and B2 (one segment) at the serving step's store (512
    gathers of D = 20480, 307 of 1024 pages near, 9 segments) and at the
    edges: rows and counters bit-exact, one launch each. The kernel writes
    the whole hit table itself, so a table of garbage would show."""
    ops, ref = card
    if kind == "main":
        from repro_torch.kernels.compare import serving_store

        *store, seg_of, n_seg = serving_store()
        store[0] = store[0].to(near_dtype)
    else:
        x = _edge_store(kind, near_dtype)
        store = [x[k] for k in ("hot", "cold_q", "cold_scales", "tier", "slot", "ids")]
        seg_of, n_seg = x["seg_of"], x["n_seg"]
    before = dict(ops.LAUNCHES)
    junk = torch.full((128,), -7, dtype=torch.int32, device="cuda")
    del junk  # the hit tables' torch.empty likely reuses this block
    rows_k, hits_k = ops.tiered_lookup_segments(*store, seg_of, n_seg)
    rk, nk, fk = ops.tiered_lookup_counted(*store)
    rows_p, hits_p = ref.tiered_lookup_segments_ref(*store, seg_of, n_seg)
    rp, np_, fp = ref.tiered_lookup_counted_ref(*store)
    torch.cuda.synchronize()
    assert torch.equal(rows_k, rows_p) and torch.equal(hits_k, hits_p)
    assert torch.equal(rk, rp) and int(nk) == int(np_) and int(fk) == int(fp)
    assert ops.LAUNCHES["tiered_segmented"] - before["tiered_segmented"] == 1
    assert ops.LAUNCHES["tiered_gather"] - before["tiered_gather"] == 1


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


@pytest.fixture
def attn():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.kernels import flash_attention, paged_attention

    return flash_attention, paged_attention


def _close(out, plain):
    assert out.dtype == plain.dtype and out.shape == plain.shape
    a, b = out.float(), plain.float()
    if out.dtype == torch.float32:
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)
    else:
        assert bool(((a - b).abs() <= 2.0 ** -7 * torch.maximum(a.abs(), b.abs()) + 1e-6).all())


def _randn(shape, seed, dtype):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype).cuda()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("lq,lk", [(512, 512), (1, 77), (100, 230), (130, 200)])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (15, 5), (16, 2), (24, 8), (28, 4)])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernel_against_plain(attn, dtype, d, hq, hkv, lq, lk, causal):
    fa, _ = attn
    q = _randn((2, hq, lq, d), 0, dtype)
    k, v = _randn((2, hkv, lk, d), 1, dtype), _randn((2, hkv, lk, d), 2, dtype)
    before = fa.LAUNCHES["flash_attention"]
    out = fa.flash_attention(q, k, v, causal=causal)
    again = fa.flash_attention(q, k, v, causal=causal)
    plain = fa.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] - before == 2
    assert torch.equal(out, again)  # deterministic
    _close(out, plain)


@pytest.mark.parametrize("lk_valid,q_offset", [(100, None), (70, 6), (200, 0)])
def test_flash_kernel_lk_valid_and_strided_views(attn, lk_valid, q_offset):
    fa, _ = attn
    x = _randn((1, 96, 3 * 128), 3, torch.bfloat16)
    kv = _randn((1, 200, 2 * 128), 4, torch.bfloat16)
    q = x.reshape(1, 96, 3, 128).transpose(1, 2)  # views, as the model hands them in
    k = kv[..., :128].reshape(1, 200, 1, 128).transpose(1, 2)
    v = kv[..., 128:].reshape(1, 200, 1, 128).transpose(1, 2)
    out = fa.flash_attention(q, k, v, causal=True, lk_valid=lk_valid, q_offset=q_offset)
    _close(out, fa.flash_attention_ref(q, k, v, causal=True, lk_valid=lk_valid, q_offset=q_offset))
    assert torch.equal(out, fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                               causal=True, lk_valid=lk_valid, q_offset=q_offset))


@pytest.mark.parametrize("q_dtype,kv_dtype", [(torch.bfloat16, torch.bfloat16),
                                              (torch.float32, torch.bfloat16),
                                              (torch.float32, torch.float32)])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (15, 5), (16, 2)])
@pytest.mark.parametrize("d", [64, 128])
def test_paged_kernel_over_the_cache_view(attn, d, hq, hkv, q_dtype, kv_dtype):
    """The engine's case: a per-slot cache viewed as pages of 16, lengths of
    1, within a page, on a page edge, ragged, full and past the end."""
    _, pa = attn
    s, ps = 256, 16
    cache = _randn((2, 8, hkv, s, d), 5, kv_dtype)  # two layers, 8 slots
    kp, vp, table = pa.cache_as_pages(cache[1], _randn((8, hkv, s, d), 6, kv_dtype), ps)
    q = _randn((8, hq, d), 7, q_dtype)
    lengths = torch.tensor([1, 7, 16, 17, 100, 255, 256, 300], dtype=torch.int32).cuda()
    before = pa.LAUNCHES["paged_attention"]
    out = pa.paged_attention(q, kp, vp, table, lengths)
    again = pa.paged_attention(q, kp, vp, table, lengths)
    plain = pa.paged_attention_ref(q, kp, vp, table, lengths)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_attention"] - before == 2
    assert torch.equal(out, again)  # deterministic
    _close(out, plain)


@pytest.mark.parametrize("ps", [16, 32])
@pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 4)])
def test_paged_kernel_over_a_shared_pool(attn, hq, hkv, ps):
    """A general pool: pages shared between sequences, out-of-range ids."""
    _, pa = attn
    kp, vp = _randn((hkv, 32, ps, 64), 8, torch.float32), _randn((hkv, 32, ps, 64), 9, torch.float32)
    g = torch.Generator().manual_seed(10)
    table = torch.randint(-3, 35, (4, 6), generator=g, dtype=torch.int32).cuda()
    lengths = torch.tensor([1, ps + 3, 2 * ps, 6 * ps], dtype=torch.int32).cuda()
    q = _randn((4, hq, 64), 11, torch.float32)
    _close(pa.paged_attention(q, kp, vp, table, lengths), pa.paged_attention_ref(q, kp, vp, table, lengths))


def test_attention_refuses_unbuilt_shapes_on_the_card(attn):
    fa, pa = attn
    q = _randn((1, 4, 16, 32), 12, torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 32"):
        fa.flash_attention(q, q, q)
    x = _randn((1, 4, 16, 65), 13, torch.bfloat16)[..., 1:]  # rows off 16-byte boundaries
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention(x, x, x)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,lq", [(1, 1500), (1, 512), (8, 1)])
def test_flash_non_causal_over_1500_keys(attn, b, lq, dtype):
    """whisper-base's three non-causal sites: the encoder (1 x 1500 frames
    over themselves), a prefill's cross-attention (a prompt of 512 over
    1500 keys) and a decode's (8 slots x 1 query over 1500 keys), 8/8
    heads of 64: 23 key tiles of 64 and a ragged one of 28,
    which TMA zero-fills and ``lk_valid`` masks. On random inputs (the
    engine's frames are zeros) and on keys past 1500 that must not count."""
    fa, _ = attn
    q = _randn((b, lq, 8 * 64), 40, dtype).reshape(b, lq, 8, 64).transpose(1, 2)
    k, v = _randn((b, 8, 1500, 64), 41, dtype), _randn((b, 8, 1500, 64), 42, dtype)
    case = _flash_case if dtype == torch.bfloat16 else _flash_tf32_case
    case(fa, q, k, v, causal=False, lk_valid=1500, q_offset=0)
    # keys past lk_valid are masked: 1500 valid of a 1536-row buffer
    kx, vx = (torch.cat([t, _randn((b, 8, 36, 64), 43, dtype) * 50], dim=2) for t in (k, v))
    out = fa.flash_attention(q, kx, vx, causal=False, lk_valid=1500, q_offset=0)
    assert torch.equal(out, fa.flash_attention(q, k, v, causal=False, lk_valid=1500, q_offset=0))


def test_flash_one_query_replays_in_a_graph(attn):
    """whisper-base's decode cross-attention inside a captured graph: B5 at
    one f32 query a slot over the 1500 keys of a fixed cache (its tensor
    maps encoded at capture, over addresses that stay fixed), its output
    in the graph's pool. Replayed after the query changes, it gives bit for
    bit what an eager call gives, and the capture counts one launch."""
    from repro_torch.runtime.graphs import StepGraph

    fa, _ = attn
    ck, cv = _randn((8, 8, 1500, 64), 44, torch.bfloat16), _randn((8, 8, 1500, 64), 45, torch.bfloat16)
    bufs = {"q": _randn((8, 1, 512), 46, torch.float32), "out": torch.zeros(8, 8, 1, 64, device="cuda")}

    def step(b):
        q = b["q"].reshape(8, 1, 8, 64).transpose(1, 2)
        b["out"].copy_(fa.flash_attention(q, ck.float(), cv.float(), causal=False, lk_valid=1500, q_offset=0))

    graph = StepGraph(step, bufs)
    assert graph.launches["flash_attention"] == 1
    for seed in (47, 48):
        bufs["q"].copy_(_randn((8, 1, 512), seed, torch.float32))
        eager = {k: v.clone() for k, v in bufs.items()}
        step(eager)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(bufs["out"], eager["out"])
    assert graph.replays == 2


def _flash_case(fa, q, k, v, **args):
    """Two launches bit-equal, one count each, within one bf16 step of the
    plain version and of the kernel's own algorithm on the card."""
    before = fa.LAUNCHES["flash_attention"]
    out = fa.flash_attention(q, k, v, **args)
    again = fa.flash_attention(q, k, v, **args)
    plain = fa.flash_attention_ref(q, k, v, **args)
    tiled = fa.flash_attention_tiled_ref(q, k, v, **args)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] - before == 2
    assert torch.equal(out, again)  # deterministic
    _close(out, plain)
    _close(out, tiled)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_tensor_cores_at_one_tile(attn, d):
    """lq = lk = 64, not causal: one wgmma tile each way, which isolates the
    fragment layouts and the 128-byte swizzle."""
    fa, _ = attn
    q, k, v = _randn((1, 2, 64, d), 20, torch.bfloat16), *(_randn((1, 2, 64, d), s, torch.bfloat16)
                                                          for s in (21, 22))
    _flash_case(fa, q, k, v, causal=False)


@pytest.mark.parametrize("group", [1, 3, 8])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_tensor_cores_ragged_long_prompt(attn, d, group):
    """lq = lk = 1000: ragged last tiles (TMA's zero fill), 16 key tiles
    through the four-stage ring, GQA groups of 1, 3 and 8."""
    fa, _ = attn
    q = _randn((1, 2 * group, 1000, d), 23, torch.bfloat16)
    k, v = _randn((1, 2, 1000, d), 24, torch.bfloat16), _randn((1, 2, 1000, d), 25, torch.bfloat16)
    _flash_case(fa, q, k, v, causal=True)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_tensor_cores_offset_and_lk_valid(attn, d, causal):
    """q_offset > 0 (a suffix of queries over a longer prefix) and keys
    past lk_valid < lk masked, v a transposed projection view."""
    fa, _ = attn
    q = _randn((2, 6, 100, d), 26, torch.bfloat16)
    k = _randn((2, 2, 300, d), 27, torch.bfloat16)
    v = _randn((2, 300, 2 * d), 28, torch.bfloat16).reshape(2, 300, 2, d).transpose(1, 2)
    _flash_case(fa, q, k, v, causal=causal, lk_valid=250, q_offset=150)


def _flash_tf32_case(fa, q, k, v, **args):
    """The f32 kernel (three TF32 products a product): two launches
    bit-equal, one count each, within 2e-5 of the plain version and of its
    own algorithm (``flash_attention_tf32_ref``)."""
    before = fa.LAUNCHES["flash_attention"]
    out = fa.flash_attention(q, k, v, **args)
    again = fa.flash_attention(q, k, v, **args)
    plain = fa.flash_attention_ref(q, k, v, **args)
    tf32 = fa.flash_attention_tf32_ref(q, k, v, **args)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] - before == 2
    assert torch.equal(out, again)  # deterministic
    _close(out, plain)
    _close(out, tf32)


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_tf32_ragged_long_prompt(attn, d, group):
    """f32 at lq = lk = 1000: ragged last tiles (TMA's zero fill), 16 key
    tiles through the ring (four stages at D = 64, two at 128), GQA."""
    fa, _ = attn
    q = _randn((1, 2 * group, 1000, d), 40, torch.float32)
    k, v = _randn((1, 2, 1000, d), 41, torch.float32), _randn((1, 2, 1000, d), 42, torch.float32)
    _flash_tf32_case(fa, q, k, v, causal=True)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_tf32_offset_lk_valid_and_views(attn, d, causal):
    """f32 with q_offset > 0, keys past lk_valid < lk masked, v a
    transposed projection view, one tile and a ragged one."""
    fa, _ = attn
    q = _randn((2, 6, 100, d), 43, torch.float32)
    k = _randn((2, 3, 300, d), 44, torch.float32)
    v = _randn((2, 300, 3 * d), 45, torch.float32).reshape(2, 300, 3, d).transpose(1, 2)
    _flash_tf32_case(fa, q, k, v, causal=causal, lk_valid=250, q_offset=150)
    q1, k1, v1 = (_randn((1, 2, 64, d), s, torch.float32) for s in (46, 47, 48))
    _flash_tf32_case(fa, q1, k1, v1, causal=False)


def test_flash_tf32_at_zamba2_width(attn):
    """zamba2-1.2b's shared block: one prompt of 512, 32/32 heads of 64."""
    fa, _ = attn
    q, k = _randn((1, 32, 512, 64), 49, torch.float32), _randn((1, 32, 512, 64), 50, torch.float32)
    v = _randn((1, 512, 32 * 64), 51, torch.float32).reshape(1, 512, 32, 64).transpose(1, 2)
    _flash_tf32_case(fa, q, k, v, causal=True, lk_valid=512, q_offset=0)


@pytest.mark.parametrize("q_dtype,kv_dtype", [(torch.bfloat16, torch.bfloat16),
                                              (torch.float32, torch.bfloat16),
                                              (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("hq,hkv,d", [(16, 2, 128), (15, 5, 64), (32, 32, 64), (24, 8, 64), (28, 4, 128)])
def test_paged_split_at_main_path_width(attn, hq, hkv, d, q_dtype, kv_dtype):
    """S = 1024 in pages of 16, so the kernel splits each sequence over a
    cluster of 8 blocks of 128 positions (at 32 KV heads, whose grid is
    large already, 2 of 512): lengths 1, a span less one, a span, a span
    and one, the cache less one, the cache, and past it."""
    _, pa = attn
    kc, vc = _randn((8, hkv, 1024, d), 29, kv_dtype), _randn((8, hkv, 1024, d), 30, kv_dtype)
    kp, vp, table = pa.cache_as_pages(kc, vc, 16)
    q = _randn((8, hq, d), 31, q_dtype)
    lengths = torch.tensor([1, 127, 128, 129, 600, 1023, 1024, 1300], dtype=torch.int32).cuda()
    assert pa.split_count(1024, hkv, 8) == {2: 8, 4: 8, 5: 8, 8: 8, 32: 2}[hkv]
    before = pa.LAUNCHES["paged_attention"]
    out = pa.paged_attention(q, kp, vp, table, lengths)
    again = pa.paged_attention(q, kp, vp, table, lengths)
    plain = pa.paged_attention_ref(q, kp, vp, table, lengths)
    split = pa.paged_attention_split_ref(q, kp, vp, table, lengths, pa.split_count(1024, hkv, 8))
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_attention"] - before == 2
    assert torch.equal(out, again)  # deterministic
    _close(out, plain)
    _close(out, split)


@pytest.mark.parametrize("n_split", [1, 2, 4, 8])
def test_paged_kernel_takes_the_split_it_is_given(attn, n_split):
    """The kernel splits by the count its caller passes (the wrapper's is
    ``split_count``): each count against the split plain version at that
    count, spans that cut pages (S = 192 in pages of 16), empty splits,
    a length past the end; a count outside 1..8 is refused."""
    _, pa = attn
    from repro_torch.kernels.paged_attention import ops

    kc, vc = _randn((4, 2, 192, 64), 32, torch.bfloat16), _randn((4, 2, 192, 64), 33, torch.bfloat16)
    kp, vp, table = pa.cache_as_pages(kc, vc, 16)
    q = _randn((4, 6, 64), 34, torch.bfloat16)
    lengths = torch.tensor([1, 25, 150, 400], dtype=torch.int32).cuda()
    before = pa.LAUNCHES["paged_attention"]
    out = ops._launch(q, kp, vp, table, lengths, n_split)
    again = ops._launch(q, kp, vp, table, lengths, n_split)
    split = pa.paged_attention_split_ref(q, kp, vp, table, lengths, n_split)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_attention"] - before == 2
    assert torch.equal(out, again)
    _close(out, split)
    _close(out, pa.paged_attention_ref(q, kp, vp, table, lengths))
    for bad in (0, 9):
        with pytest.raises(RuntimeError, match="invalid argument"):
            ops._launch(q, kp, vp, table, lengths, bad)
    assert pa.LAUNCHES["paged_attention"] - before == 2


@pytest.fixture
def scans():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.kernels import mamba2_scan, rwkv6_scan

    return rwkv6_scan, mamba2_scan


def _scan_close(out, plain):
    for a, b in zip(out, plain):
        assert a.dtype == torch.float32 and a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))


def _wkv6_args(seed, b, t, h, hd, strong, state):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).cuda()
    mu = 1.5 if strong else -1.0
    lw = torch.from_numpy(-np.exp(rng.normal(mu, 1.0, (b, t, h, hd))).astype(np.float32)).cuda()
    return [f(b, t, h, hd), f(b, t, h, hd), f(b, t, h, hd), lw, f(h, hd),
            f(b, h, hd, hd) if state else None]


def _ssd_args(seed, b, t, h, p, n, strong, state):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).cuda()
    dt = torch.from_numpy(np.log1p(np.exp(rng.standard_normal((b, t, h)))).astype(np.float32)).cuda()
    a = torch.from_numpy(-np.exp(rng.normal(2.0 if strong else 0.0, 1.0, h)).astype(np.float32)).cuda()
    return [f(b, t, h, p), dt, a, f(b, t, n), f(b, t, n), f(h), f(b, h, p, n) if state else None]


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("b,t", [(2, 50), (8, 1), (1, 96)])
@pytest.mark.parametrize("hd", [16, 64])
def test_wkv6_kernel_against_plain(scans, hd, b, t, strong, state):
    wkv, _ = scans
    args = _wkv6_args(hd + t, b, t, 3, hd, strong, state)
    before = wkv.LAUNCHES["wkv6"]
    out = wkv.wkv6_chunked(*args)
    again = wkv.wkv6_chunked(*args)
    plain = wkv.wkv6_ref(*args)
    torch.cuda.synchronize()
    assert wkv.LAUNCHES["wkv6"] - before == 2
    assert all(torch.equal(x, y) for x, y in zip(out, again))  # deterministic
    _scan_close(out, plain)


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("b,t", [(2, 50), (8, 1), (1, 96)])
@pytest.mark.parametrize("p,n", [(16, 16), (64, 64), (16, 64)])
def test_ssd_kernel_against_plain(scans, p, n, b, t, strong, state):
    _, ssd = scans
    args = _ssd_args(p + n + t, b, t, 3, p, n, strong, state)
    before = ssd.LAUNCHES["ssd"]
    out = ssd.ssd_chunked(*args)
    again = ssd.ssd_chunked(*args)
    plain = ssd.ssd_ref(*args)
    torch.cuda.synchronize()
    assert ssd.LAUNCHES["ssd"] - before == 2
    assert all(torch.equal(x, y) for x, y in zip(out, again))  # deterministic
    _scan_close(out, plain)


@pytest.mark.parametrize("t", [1, 40])
def test_scans_write_the_state_in_place(scans, t):
    """The model's decode: the final state over the initial one, bit for
    bit what a separate output gets, and the same tensor returned; WKV6 at
    each built hd (T = 1 streams the state through registers)."""
    wkv, ssd = scans
    for hd in (16, 32, 64):
        args = _wkv6_args(1 + hd, 4, t, 2, hd, False, True)
        y, s = wkv.wkv6_chunked(*args)
        cache = args[5].clone()
        yi, si = wkv.wkv6_chunked(*args[:5], cache, inplace=True)
        torch.cuda.synchronize()
        assert si is cache and torch.equal(cache, s) and torch.equal(yi, y)
        _scan_close((y, s), wkv.wkv6_ref(*args))
    args = _ssd_args(2, 4, t, 2, 64, 64, False, True)
    y, s = ssd.ssd_chunked(*args)
    cache = args[6].clone()
    yi, si = ssd.ssd_chunked(*args[:6], cache, inplace=True)
    torch.cuda.synchronize()
    assert si is cache and torch.equal(cache, s) and torch.equal(yi, y)


def test_scans_read_strided_views(scans):
    """The models hand in views: wkv6's inputs as reshaped projections,
    SSD's x, B and C as slices of the conv output."""
    wkv, ssd = scans
    g = torch.Generator().manual_seed(4)
    big = torch.randn(2, 30, 4 * 3 * 64, generator=g).cuda()
    r, k, v, lw = (big[..., i * 192:(i + 1) * 192].reshape(2, 30, 3, 64) for i in range(4))
    lw = -lw.abs()
    u = torch.randn(3, 64, generator=g).cuda()
    out = wkv.wkv6_chunked(r, k, v, lw, u)
    ref = wkv.wkv6_chunked(*(x.contiguous() for x in (r, k, v, lw)), u)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    conv = torch.randn(2, 30, 3 * 64 + 2 * 16, generator=g).cuda()
    x = conv[..., :192].reshape(2, 30, 3, 64)
    bm, cm = conv[..., 192:208], conv[..., 208:]
    dt = torch.rand(2, 30, 3, generator=g).cuda()
    a, d = -torch.rand(3, generator=g).cuda(), torch.randn(3, generator=g).cuda()
    out = ssd.ssd_chunked(x, dt, a, bm, cm, d)
    ref = ssd.ssd_chunked(x.contiguous(), dt, a, bm.contiguous(), cm.contiguous(), d)
    assert all(torch.equal(a_, b_) for a_, b_ in zip(out, ref))


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("n_split", [1, 2, 3, 4, 5, 8])
def test_ssd_kernel_takes_the_split_it_is_given(scans, n_split, state):
    """The prefill kernel splits each sequence over the cluster count its
    caller passes (the wrapper's is ``split_count``): against the split
    plain version at that count and the sequential one, T = 300 (ten
    chunks, the last ragged), strong decays, bit-equal reruns; a count
    outside 1..8 is refused."""
    _, ssd = scans
    from repro_torch.kernels.mamba2_scan import ops

    args = _ssd_args(60 + n_split, 2, 300, 3, 64, 64, True, state)
    before = ssd.LAUNCHES["ssd"]
    out = ops._launch(*args, None, n_split)
    again = ops._launch(*args, None, n_split)
    torch.cuda.synchronize()
    assert ssd.LAUNCHES["ssd"] - before == 2
    assert all(torch.equal(x, y) for x, y in zip(out, again))
    _scan_close(out, ssd.ssd_split_ref(*args, n_split=n_split))
    _scan_close(out, ssd.ssd_ref(*args))
    for bad in (0, 9):
        with pytest.raises(RuntimeError, match="invalid argument"):
            ops._launch(*args, None, bad)
    assert ssd.LAUNCHES["ssd"] - before == 2


@pytest.mark.parametrize("t", [1, 512])
def test_ssd_at_zamba2_width_in_place(scans, t):
    """zamba2-1.2b's widths (64 heads, P = N = 64): the prompt of 512 over a
    cluster of 2, and the decode path (T = 1, 8 slots), in place with
    s_out the given state itself, against both plain versions."""
    _, ssd = scans
    b = 1 if t > 1 else 8
    assert ssd.split_count(t, b, 64) == (2 if t > 1 else 1)
    args = _ssd_args(70 + t, b, t, 64, 64, 64, True, True)
    y, s = ssd.ssd_chunked(*args)
    cache = args[6].clone()
    yi, si = ssd.ssd_chunked(*args[:6], cache, inplace=True)
    torch.cuda.synchronize()
    assert si is cache and torch.equal(cache, s) and torch.equal(yi, y)
    _scan_close((y, s), ssd.ssd_ref(*args))
    _scan_close((y, s), ssd.ssd_split_ref(*args, n_split=ssd.split_count(t, b, 64)))


@pytest.mark.parametrize("pn", [16, 32, 64])
def test_ssd_prefill_clusters_fit_the_card(scans, pn):
    """The card keeps at least as many prefill clusters of each count
    resident as ``split_count`` assumes, at every built P = N; so the 64
    clusters of zamba2's prompt (split 2) run in one wave."""
    _, ssd = scans
    from repro_torch.kernels.mamba2_scan import ops, ref

    fit = {n: ops.max_active_clusters(pn, pn, n) for n in ref.RESIDENT_CLUSTERS}
    assert all(fit[n] >= c for n, c in ref.RESIDENT_CLUSTERS.items()), fit
    assert fit[ssd.split_count(512, 1, 64)] >= 64


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("n_split", [1, 2, 3, 4, 5, 8])
def test_wkv6_kernel_takes_the_split_it_is_given(scans, n_split, state):
    """The WKV6 prefill kernel splits each sequence over the cluster count its
    caller passes (the wrapper's is ``split_count``): against the split
    plain version at that count and the sequential one, T = 300 (ten
    chunks, the last ragged), strong decays, bit-equal reruns; a count
    outside 1..8 is refused."""
    wkv, _ = scans
    from repro_torch.kernels.rwkv6_scan import ops

    args = _wkv6_args(80 + n_split, 2, 300, 3, 64, True, state)
    before = wkv.LAUNCHES["wkv6"]
    out = ops._launch(*args, None, n_split)
    again = ops._launch(*args, None, n_split)
    torch.cuda.synchronize()
    assert wkv.LAUNCHES["wkv6"] - before == 2
    assert all(torch.equal(x, y) for x, y in zip(out, again))
    _scan_close(out, wkv.wkv6_split_ref(*args, n_split=n_split))
    _scan_close(out, wkv.wkv6_ref(*args))
    for bad in (0, 9):
        with pytest.raises(RuntimeError, match="invalid argument"):
            ops._launch(*args, None, bad)
    assert wkv.LAUNCHES["wkv6"] - before == 2


@pytest.mark.parametrize("t", [1, 512])
def test_wkv6_at_rwkv6_width_in_place(scans, t):
    """rwkv6-7b's widths (64 heads of 64): the prompt of 512 over a cluster of
    2, and the decode path (T = 1, 8 slots), in place with s_out the given
    state itself, against both plain versions."""
    wkv, _ = scans
    b = 1 if t > 1 else 8
    assert wkv.split_count(t, b, 64) == (2 if t > 1 else 1)
    args = _wkv6_args(100 + t, b, t, 64, 64, True, True)
    y, s = wkv.wkv6_chunked(*args)
    cache = args[5].clone()
    yi, si = wkv.wkv6_chunked(*args[:5], cache, inplace=True)
    torch.cuda.synchronize()
    assert si is cache and torch.equal(cache, s) and torch.equal(yi, y)
    _scan_close((y, s), wkv.wkv6_ref(*args))
    _scan_close((y, s), wkv.wkv6_split_ref(*args, n_split=wkv.split_count(t, b, 64)))


@pytest.mark.parametrize("hd", [16, 32, 64])
def test_wkv6_prefill_clusters_fit_the_card(scans, hd):
    """The card keeps at least as many WKV6 prefill clusters of each count
    resident as ``split_count`` assumes, at every built hd; so the 64
    clusters of rwkv6-7b's prompt (split 2) run in one wave."""
    wkv, _ = scans
    from repro_torch.kernels.rwkv6_scan import ops, ref

    fit = {n: ops.max_active_clusters(hd, n) for n in ref.RESIDENT_CLUSTERS}
    assert all(fit[n] >= c for n, c in ref.RESIDENT_CLUSTERS.items()), fit
    assert fit[wkv.split_count(512, 1, 64)] >= 64


@pytest.mark.parametrize("n_split", [1, 2])
def test_wkv6_prefill_grid_past_65535_sequences(scans, n_split):
    """A WKV6 prefill of 1025 sequences at 64 heads (65,600 (b, h) pairs,
    past the 65,535 a grid's y or z dim takes) launches, against the plain
    version."""
    wkv, _ = scans
    from repro_torch.kernels.rwkv6_scan import ops

    args = _wkv6_args(110 + n_split, 1025, 40, 64, 16, False, True)
    out = ops._launch(*args, None, n_split)
    _scan_close(out, wkv.wkv6_ref(*args))


@pytest.mark.parametrize("n_split", [1, 2])
def test_ssd_prefill_grid_past_65535_sequences(scans, n_split):
    """A prefill of 1025 sequences at 64 heads (65,600 (b, h) pairs, past
    the 65,535 a grid's y or z dim takes) launches, against the plain
    version."""
    _, ssd = scans
    from repro_torch.kernels.mamba2_scan import ops

    args = _ssd_args(90 + n_split, 1025, 64, 64, 16, 16, False, True)
    out = ops._launch(*args, None, n_split)
    _scan_close(out, ssd.ssd_ref(*args))


def test_scans_refuse_what_they_are_not_built_for(scans):
    wkv, ssd = scans
    x = torch.zeros(1, 4, 2, 128, device="cuda")[..., ::2]  # stride 2 along hd
    with pytest.raises(ValueError, match="unit stride"):
        wkv.wkv6_chunked(x, x, x, x, torch.zeros(2, 64, device="cuda"))
    y = torch.zeros(1, 4, 2, 48, device="cuda")
    with pytest.raises(ValueError, match="head_dim 48"):
        wkv.wkv6_chunked(y, y, y, y, torch.zeros(2, 48, device="cuda"))
    bm = torch.zeros(1, 4, 32, device="cuda")[..., ::2]
    with pytest.raises(ValueError, match="unit stride"):
        ssd.ssd_chunked(torch.zeros(1, 4, 2, 16, device="cuda"), torch.zeros(1, 4, 2, device="cuda"),
                        torch.zeros(2, device="cuda"), bm, bm, torch.zeros(2, device="cuda"))
    s0 = torch.zeros(1, 2, 64, 64, device="cuda")
    with pytest.raises(ValueError, match="several devices"):
        wkv.wkv6_chunked(*(torch.zeros(1, 4, 2, 64, device="cuda") for _ in range(4)),
                         torch.zeros(2, 64), s0)


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-3b-a800m", "rwkv6-7b", "zamba2-1.2b",
                                  "qwen2-vl-7b", "whisper-base"])
def test_reduced_engine_on_card_equals_cpu(card, arch):
    """The whole device-tiered engine at reduced size: the card (kernels) and
    the CPU (plain versions) give the same books. The books follow the
    schedule, not the token values, so an argmax near-tie that the other
    summation order flips cannot change them. On the card every layer runs
    its kernel once per dispatch: attention per dense layer, WKV6 per rwkv6
    layer, SSD per zamba2 layer and attention per application of zamba2's
    shared block (``_card_cfg``: the attention kernels are built for
    head_dim 64 and 128); the scans take the reduced widths of 16 as they
    are."""
    import dataclasses

    from repro_torch.configs.workloads import get_profile
    from repro_torch.data.requests import RequestGenerator
    from repro_torch.kernels import flash_attention, mamba2_scan, paged_attention, rwkv6_scan
    from repro_torch.models.api import get_model, kernel_launches
    from repro_torch.runtime.serving import EngineConfig, ServingEngine

    cfg = _card_cfg(arch)
    api = get_model(cfg)
    prof = dataclasses.replace(get_profile("Web1"), prompt_mean=24, decode_mean=8,
                               prefix_share=0.5, n_prefixes=2)
    counters = (flash_attention.LAUNCHES, paged_attention.LAUNCHES, rwkv6_scan.LAUNCHES,
                mamba2_scan.LAUNCHES)
    books = {}
    for where in ("cuda", "cpu"):
        eng = ServingEngine(api, api.init(0, device=where), EngineConfig(
            max_batch=4, max_len=64, n_pages=256, near_frac=0.02, placement_window=4,
            device_tiering=True, tiered_identity_scales=True, tiered_verify=True,
        ), seed=0, device=where)
        for c in counters:
            for k in c:
                c[k] = 0
        eng.run(RequestGenerator(prof, vocab_size=cfg.vocab_size, seed=0), n_requests=6)
        books[where] = (eng.live_counters(), eng.stats()["device_tiering"])
        # the decodes replay a captured graph on the card: its launches are
        # the graph's captured ones times its replays
        replayed = eng.graph_launches()
        launched = {k: v + replayed[k] for c in counters for k, v in c.items()}
        pre, dec = eng.prefill_dispatches, eng.model_dispatches - eng.prefill_dispatches
        want = kernel_launches(cfg, pre, dec)
        assert dec > 0
        assert launched == (want if where == "cuda" else dict.fromkeys(want, 0))
    assert books["cuda"] == books["cpu"]
    assert books["cuda"][1]["max_read_error"] == 0.0


# ---------------------------------------------------------------------------
# the serving engine's captured graphs


def _card_cfg(arch):
    """The reduced configs the attention kernels take (head_dim 64): smollm
    and granite-moe keep a GQA group of 3 (3 query heads of 64 over 1 KV
    head), qwen2-vl its group of 7 (7 over 1, M-RoPE sections summing to
    32), qwen2-moe, zamba2's shared block and whisper take 2/2 heads of 64
    over d 128."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch).reduced()
    if arch in ("smollm-360m", "granite-moe-3b-a800m"):
        cfg = dataclasses.replace(cfg, d_model=192, n_heads=3, n_kv_heads=1)
    elif arch in ("zamba2-1.2b", "qwen2-moe-a2.7b", "whisper-base"):
        cfg = dataclasses.replace(cfg, d_model=128, n_heads=2, n_kv_heads=2)
    elif arch == "qwen2-vl-7b":
        cfg = dataclasses.replace(cfg, d_model=448, n_heads=7, n_kv_heads=1, mrope_sections=(8, 12, 12))
    return cfg


def _engine_run(api, model, where, chunk, eager=False, **over):
    """Six Web1 requests through a device-tiered engine (``over``: more
    engine options): (engine, per-step next tokens, the wrappers' launches,
    the logits of one more decode)."""
    import dataclasses

    from repro_torch.configs.workloads import get_profile
    from repro_torch.data.requests import RequestGenerator
    from repro_torch.kernels import launch_counts
    from repro_torch.runtime.serving import EngineConfig, ServingEngine

    prof = dataclasses.replace(get_profile("Web1"), prompt_mean=24, decode_mean=8,
                               prefix_share=0.5, n_prefixes=2)
    eng = ServingEngine(api, model, EngineConfig(
        max_batch=4, max_len=64, n_pages=256, near_frac=0.02, placement_window=4,
        device_tiering=True, tiered_identity_scales=True, tiered_verify=True, prefill_chunk=chunk,
        **over,
    ), seed=0, device=where)
    if eager:  # what the graphs replay, run as it stands
        eng._dispatch = lambda name: getattr(eng, f"_{name}_fn")(eng._bufs)
    before = launch_counts()
    gen = RequestGenerator(prof, vocab_size=api.cfg.vocab_size, seed=0)
    for _ in range(6):
        eng.submit(next(gen))
    toks = []
    while eng.queue or any(s.active for s in eng.slots):
        eng.step()
        toks.append(eng.next_tokens.cpu().clone())
    after = launch_counts()
    cache = {k: v.clone() for k, v in eng.cache.items()}
    logits, _ = api.decode(model, cache, eng.next_tokens[:, None], page_size=16)
    return eng, torch.stack(toks), {k: after[k] - before[k] for k in after}, logits


@pytest.mark.parametrize("chunk", [0, 8])
@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-3b-a800m", "qwen2-moe-a2.7b",
                                  "rwkv6-7b", "zamba2-1.2b", "qwen2-vl-7b", "whisper-base"])
def test_graph_replay_equals_eager(card, arch, chunk):
    """The engine on the card replays its captured decode and chunk-column
    graphs; run eagerly instead (the same functions), it gives bit-equal
    tokens, caches, next-step logits, live counters and books. Launches:
    the eager run's wrappers count every model kernel, once a layer a
    prefill and once a layer a whole-batch decode; in the graph run they
    count only the prefills, and the replays the rest."""
    from repro_torch.models.api import get_model, kernel_launches
    from repro_torch.runtime.serving import CHUNKABLE_FAMILIES

    cfg = _card_cfg(arch)
    api = get_model(cfg)
    model = api.init(0, device="cuda")
    g_eng, g_toks, g_launched, g_logits = _engine_run(api, model, "cuda", chunk)
    e_eng, e_toks, e_launched, e_logits = _engine_run(api, model, "cuda", chunk, eager=True)
    assert torch.equal(g_toks, e_toks) and torch.equal(g_logits, e_logits)
    assert all(torch.equal(g_eng.cache[k], e_eng.cache[k]) for k in g_eng.cache)
    assert g_eng.live_counters() == e_eng.live_counters()
    assert g_eng.stats() == e_eng.stats()
    assert g_eng.stats()["device_tiering"]["max_read_error"] == 0.0
    model_kernels = ("flash_attention", "paged_attention", "wkv6", "ssd")
    want = kernel_launches(cfg, g_eng.prefill_dispatches, g_eng.batch_decodes)
    prefill_only = kernel_launches(cfg, g_eng.prefill_dispatches, 0)
    replayed = g_eng.graph_launches()
    assert {k: e_launched[k] for k in want} == want
    assert {k: g_launched[k] for k in want} == prefill_only
    assert {k: g_launched[k] + replayed[k] for k in want} == want
    assert sum(g.replays for g in g_eng._graphs.values()) == g_eng.batch_decodes > 0
    assert e_eng.graph_launches() == dict.fromkeys(e_eng.graph_launches(), 0)
    assert g_launched["tiered_segmented"] == e_launched["tiered_segmented"] == g_eng.engine_steps
    assert all(v == 0 for k, v in replayed.items() if k not in model_kernels)
    # vlm and audio are not chunkable: with a chunk budget they prefill whole
    assert g_eng.chunking == (chunk > 0 and cfg.family in CHUNKABLE_FAMILIES)
    if g_eng.chunking:
        assert g_eng.chunk_columns > 0 and g_eng._graphs["column"].replays == g_eng.chunk_columns
        assert g_eng.prefill_dispatches == 0
    else:
        assert sorted(g_eng._graphs) == ["decode"] and g_eng.prefill_dispatches > 0


@pytest.mark.parametrize("arch", ["smollm-360m", "qwen2.5-3b", "granite-moe-3b-a800m", "rwkv6-7b",
                                  "zamba2-1.2b"])
def test_held_casts_on_the_card(card, arch):
    """At bf16 compute every held cast of a layer, and the head's, is
    bit-equal to a per-call ``p.to(bfloat16)`` on the card."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import common
    from repro_torch.models.api import get_model

    api = get_model(dataclasses.replace(get_config(arch).reduced(), compute_dtype="bfloat16"))
    model = api.init(0, device="cuda")

    def leaves(tree):
        for v in tree.values():
            yield from (leaves(v) if isinstance(v, dict) else (v,))

    for node in (m for m in model.modules() if isinstance(m, common.ParamTree)):
        held = list(leaves(node.tree(torch.bfloat16)))
        fresh = [p.to(torch.bfloat16) for _, p in node.named_parameters()]
        assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(held, fresh))
    head = "embed" if api.cfg.tie_embeddings else "lm_head"
    assert torch.equal(common.cast(model, head, torch.bfloat16), getattr(model, head).to(torch.bfloat16))


@pytest.mark.parametrize("arch", ["smollm-360m", "rwkv6-7b", "zamba2-1.2b"])
def test_chunked_engine_on_card_equals_cpu(card, arch):
    """The chunked engine (prefill_chunk 8) on the card (graphs over the
    kernels) against the same engine on the CPU (plain versions): the same
    books; tokens equal at 0.9 of the steps or more, since an argmax may
    flip at a near-tie under the other summation order."""
    from repro_torch.models.api import get_model, kernel_launches

    cfg = _card_cfg(arch)
    api = get_model(cfg)
    runs = {where: _engine_run(api, api.init(0, device=where), where, 8) for where in ("cuda", "cpu")}
    (ge, gt, gl, _), (ce, ct, cl, _) = runs["cuda"], runs["cpu"]
    assert ge.live_counters() == ce.live_counters()
    assert ge.stats() == ce.stats()
    assert ge.chunk_columns == ce.chunk_columns and ge.batch_decodes == ce.batch_decodes
    assert float((gt == ct).float().mean()) >= 0.9
    replayed = ge.graph_launches()
    want = kernel_launches(cfg, 0, ge.batch_decodes)
    assert {k: gl[k] + replayed[k] for k in want} == want
    assert {k: cl[k] for k in want} == dict.fromkeys(want, 0)


@pytest.mark.parametrize("hq,hkv,d", [(15, 5, 64), (16, 2, 128), (32, 32, 64)])
def test_decode_kernels_replay_in_a_graph(card, hq, hkv, d):
    """The main path's decode kernels at full width, captured in one graph:
    paged attention over S = 1024 (each sequence split over a cluster of up
    to 8 blocks) and the WKV6 and SSD decode steps at 64 heads of 64, in
    place. Replayed, they give bit for bit what they give run eagerly."""
    from repro_torch.kernels import mamba2_scan, paged_attention, rwkv6_scan
    from repro_torch.runtime.graphs import StepGraph

    g = torch.Generator().manual_seed(hq)
    rand = lambda *shape: torch.randn(*shape, generator=g).cuda()
    kc, vc = rand(8, hkv, 1024, d).bfloat16(), rand(8, hkv, 1024, d).bfloat16()
    lengths = torch.tensor([1, 23, 512, 547, 560, 600, 1024, 1300], dtype=torch.int32, device="cuda")
    wkv = [rand(8, 1, 64, 64) for _ in range(3)] + [-rand(8, 1, 64, 64).abs(), rand(64, 64)]
    ssd = [rand(8, 1, 64, 64), rand(8, 1, 64).abs(), -rand(64).abs(), rand(8, 1, 64), rand(8, 1, 64),
           rand(64)]
    bufs = {"q": rand(8, hq, d).bfloat16(), "out": torch.zeros(8, hq, d, device="cuda").bfloat16(),
            "wkv": rand(8, 64, 64, 64), "ssd": rand(8, 64, 64, 64), "y": torch.zeros(2, 8, 64, 64, device="cuda")}

    def step(b):
        kp, vp, table = paged_attention.cache_as_pages(kc, vc, 16)
        b["out"].copy_(paged_attention.paged_attention(b["q"], kp, vp, table, lengths))
        y, _ = rwkv6_scan.wkv6_chunked(*wkv, b["wkv"], inplace=True)
        b["y"][0].copy_(y[:, 0])
        y, _ = mamba2_scan.ssd_chunked(*ssd, b["ssd"], inplace=True)
        b["y"][1].copy_(y[:, 0])

    eager = {k: v.clone() for k, v in bufs.items()}
    step(eager)
    graph = StepGraph(step, bufs)
    assert paged_attention.split_count(1024, hkv, 8) > 1
    assert graph.launches["paged_attention"] == graph.launches["wkv6"] == graph.launches["ssd"] == 1
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(bufs[k], eager[k]) for k in bufs)


def test_failed_capture_raises(card):
    """A dispatch that reads the host under capture fails the capture, and
    the failure raises, from the graph and from the engine that would have
    replayed it; nothing runs it eagerly instead."""
    from repro_torch.models.api import get_model
    from repro_torch.runtime.graphs import StepGraph
    from repro_torch.runtime.serving import EngineConfig, ServingEngine

    x = {"x": torch.zeros(4, device="cuda")}
    with pytest.raises(RuntimeError):
        StepGraph(lambda b: b["x"].add_(float(b["x"].sum().item())), x)
    api = get_model(_card_cfg("smollm-360m"))
    model = api.init(0, device="cuda")
    decode = api.decode

    def reads_the_host(*a, **k):
        logits, cache = decode(*a, **k)
        logits.sum().item()
        return logits, cache

    api.decode = reads_the_host
    with pytest.raises(RuntimeError):
        ServingEngine(api, model, EngineConfig(max_batch=4, max_len=64, n_pages=256), seed=0,
                      device="cuda")
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the failure machinery and the fleet on the card


def _quiet(eng) -> bool:
    """A step that neither drains the counter plane nor admits (a whole-slot
    admission reads its first token back)."""
    drains = (eng.engine_steps + 1) % eng.ecfg.placement_window == 0
    return not drains and not (eng.queue and any(not s.active for s in eng.slots))


@pytest.mark.parametrize("chunk", [0, 8])
def test_degraded_engine_keeps_the_step_budget(card, chunk):
    """Far-tier-only serving on the card: every near row demoted through the
    real migration, then one tiered launch a step, no host read and no sync
    in a step that neither drains nor admits, every read a far hit."""
    import dataclasses
    import warnings

    from repro_torch.configs.workloads import get_profile
    from repro_torch.data.requests import RequestGenerator
    from repro_torch.device import HOST_READS
    from repro_torch.kernels import launch_counts
    from repro_torch.models.api import get_model
    from repro_torch.runtime.serving import EngineConfig, ServingEngine

    api = get_model(_card_cfg("smollm-360m"))
    eng = ServingEngine(api, api.init(0, device="cuda"), EngineConfig(
        max_batch=4, max_len=64, n_pages=256, near_frac=0.05, placement_window=4,
        device_tiering=True, prefill_chunk=chunk), seed=0, device="cuda")
    assert eng.enter_degraded() == eng.placement.near_capacity
    assert eng.tiered.near_count == 0 and eng.tiered.degraded
    prof = dataclasses.replace(get_profile("Web1"), prompt_mean=24, decode_mean=8,
                               prefix_share=0.5, n_prefixes=2)
    gen = RequestGenerator(prof, vocab_size=api.cfg.vocab_size, seed=0)
    for _ in range(6):
        eng.submit(next(gen))
    quiet = reads = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        while eng.queue or any(s.active for s in eng.slots):
            check, before, reads0 = _quiet(eng), launch_counts(), HOST_READS["copies"]
            torch.cuda.set_sync_debug_mode("warn" if check else 0)
            try:
                eng.step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            assert launch_counts()["tiered_segmented"] - before["tiered_segmented"] == 1
            quiet += check
            reads += (HOST_READS["copies"] - reads0) if check else 0
    syncs = [w for w in caught if "synchroniz" in str(w.message) and "prototype" not in str(w.message)]
    dev = eng.stats()["device_tiering"]
    assert quiet > 0 and reads == 0 and not syncs
    assert eng.tiered.dispatches == eng.engine_steps
    assert dev["near_hits"] == 0 and dev["far_hits"] > 0 and dev["near_count"] == 0


def _abort_run(api, model, chunk, eager):
    """Six requests, three steps, ``abort_all``, the aborted requests
    re-submitted, and the run to its end: (engine, tokens, aborted pairs)."""
    import dataclasses

    from repro_torch.configs.workloads import get_profile
    from repro_torch.data.requests import RequestGenerator
    from repro_torch.runtime.serving import EngineConfig, ServingEngine

    eng = ServingEngine(api, model, EngineConfig(
        max_batch=4, max_len=64, n_pages=256, near_frac=0.05, placement_window=4,
        device_tiering=True, predictor="trace", prefetch_promote=True, prefill_chunk=chunk,
    ), seed=0, device="cuda")
    if eager:
        eng._dispatch = lambda name: getattr(eng, f"_{name}_fn")(eng._bufs)
    prof = dataclasses.replace(get_profile("Web1"), prompt_mean=24, decode_mean=8,
                               prefix_share=0.5, n_prefixes=2)
    gen = RequestGenerator(prof, vocab_size=api.cfg.vocab_size, seed=0)
    for _ in range(6):
        eng.submit(next(gen))
    toks = []
    for _ in range(3):
        eng.step()
        toks.append(eng.next_tokens.cpu().clone())
    mid_prompt = sum(s.prefilling for s in eng.slots)
    aborted = eng.abort_all()
    for r, _ in aborted:
        eng.submit(r)
    while eng.queue or any(s.active for s in eng.slots):
        eng.step()
        toks.append(eng.next_tokens.cpu().clone())
    return eng, torch.stack(toks), [(r.rid, d) for r, d in aborted], mid_prompt


@pytest.mark.parametrize("chunk", [0, 8])
def test_abort_and_readmit_under_graphs_equals_eager(card, chunk):
    """Slots freed by ``abort_all`` are refilled in place by the next
    admission (a slot write on the whole-slot path, a zeroing on the
    chunked one, a mid-prompt slot's chunk plan gone): under graph replay
    the tokens, caches and books are bit-equal to eager dispatch."""
    from repro_torch.models.api import get_model

    api = get_model(_card_cfg("smollm-360m"))
    model = api.init(0, device="cuda")
    g_eng, g_toks, g_ab, g_mid = _abort_run(api, model, chunk, eager=False)
    e_eng, e_toks, e_ab, e_mid = _abort_run(api, model, chunk, eager=True)
    assert g_ab == e_ab and len(g_ab) > 0 and (g_mid > 0) == (chunk > 0) and g_mid == e_mid
    assert torch.equal(g_toks, e_toks)
    assert all(torch.equal(g_eng.cache[k], e_eng.cache[k]) for k in g_eng.cache)
    assert g_eng.stats() == e_eng.stats()
    assert g_eng.stats()["requests_finished"] == 6
    assert sum(g.replays for g in g_eng._graphs.values()) == g_eng.batch_decodes > 0


def test_reduced_fleet_on_card_equals_cpu(card):
    """``build_fleet`` on the card and on the CPU, over the head_dim-64
    reduced smollm (put in its model cache for both devices), through a
    crash with a replacement host, a hang and a degraded host, trace
    prediction and the prefetch window on: the chaos log, the outcome
    ledger and the fleet books are equal."""
    import dataclasses

    import repro_torch.fleet as fleet_mod
    from repro_torch.configs.workloads import get_profile
    from repro_torch.data.requests import RequestGenerator, interleave
    from repro_torch.models.api import get_model

    cfg = _card_cfg("smollm-360m")
    api = get_model(cfg)
    books = {}
    for where in ("cuda", "cpu"):
        fleet_mod._MODEL_CACHE[("smollm-360m", where)] = (cfg, api, api.init(0, device=where))
        try:
            fl = fleet_mod.build_fleet(
                3, policy="least-loaded", seed=0, device=where, device_tiering=True,
                predictor="trace", prefetch_promote=True, trace_window=16, trace_period=32,
                admission=fleet_mod.AdmissionController(fleet_mod.SLOModel(max_delay_steps=64.0)),
                autotier=dict(near_frac=0.30, epoch_steps=8), elastic=dict(max_replicas=4))
        finally:
            fleet_mod._MODEL_CACHE.pop(("smollm-360m", where))
        fleet_mod.ChaosEngine(fl, [fleet_mod.FaultEvent(6.0, "crash", rid=1, duration=6.0),
                                   fleet_mod.FaultEvent(10.0, "hang", rid=0, duration=3.0),
                                   fleet_mod.FaultEvent(14.0, "degrade", rid=2, duration=12.0)])
        gens = [RequestGenerator(dataclasses.replace(get_profile(base), prompt_mean=pm, decode_mean=dm),
                                 vocab_size=cfg.vocab_size, seed=i, tenant=t)
                for i, (t, base, pm, dm) in enumerate((("cache", "Cache1", 8, 6), ("web", "Web1", 24, 8)))]
        stats = fl.run(iter(interleave(gens, 24)), n_requests=24, max_steps=600, submit_per_step=3)
        books[where] = (list(fl.chaos.log), fl.outcome_report(), repr(stats))
    assert books["cuda"] == books["cpu"]
    assert books["cuda"][1]["complete"] and len(books["cuda"][0]) == 6


# ---------------------------------------------------------------------------
# the sharded engine (one card) and the moe family's routing on the card


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_store_on_card_equals_cpu(card, n_shards):
    """The same global stream through a sharded store on the card and on
    the CPU: rows, drained planes, migration books, per-shard budget and the
    per-shard drain deltas are equal; an idle shard launches nothing."""
    from repro_torch.kernels import launch_counts
    from repro_torch.runtime.sharded import ShardedTieredKV

    rows = np.random.default_rng(0).integers(-127, 128, size=(64, 40)).astype(np.float32)
    books = {}
    for where in ("cuda", "cpu"):
        store = ShardedTieredKV(64, 40, 10, n_shards, identity_scales=True, counter_slots=6,
                                device=where)
        store.write(np.arange(64), torch.as_tensor(rows, device=where))
        rng = np.random.default_rng(7)
        got, moved = [], []
        for _ in range(6):
            moved.append(store.migrate(rng.choice(64, size=rng.integers(0, 11), replace=False)))
            sizes = rng.integers(1, 9, size=rng.integers(1, 7))
            ids = rng.integers(0, 64, size=sizes.sum())
            before = launch_counts()["tiered_segmented"]
            got.append(store.lookup_segments(
                ids, np.repeat(np.arange(sizes.size), sizes).astype(np.int32), 7,
                slot_idx=list(range(sizes.size)), tenant_idx=list(rng.integers(0, 3, sizes.size)),
                role_idx=list(rng.integers(0, 2, sizes.size))).cpu())
            busy = np.unique(ids % n_shards).size
            assert launch_counts()["tiered_segmented"] - before == (busy if where == "cuda" else 0)
        d = store.drain_counters()
        books[where] = (torch.cat(got), moved, {k: np.asarray(v).tolist() for k, v in d.items()},
                        store.take_shard_drains(), store.stats())
    (rg, mg, dg, sg, stg), (rc, mc, dc, sc, stc) = books["cuda"], books["cpu"]
    assert torch.equal(rg, rc) and mg == mc and dg == dc and sg == sc and stg == stc


@pytest.mark.parametrize("chunk", [0, 8])
def test_sharded_engine_on_card_equals_cpu(card, chunk):
    """A 2-shard engine on the card (graphs, kernels) against the same on
    the CPU: live counters and books equal, and its tokens and books equal
    the 1-shard engine's on the card; at most one tiered launch per shard a
    step."""
    from repro_torch.models.api import get_model

    cfg = _card_cfg("smollm-360m")
    api = get_model(cfg)
    model = api.init(0, device="cuda")
    cpu_model = api.init(0, device="cpu")
    runs = {}
    for label, where, n in (("card2", "cuda", 2), ("card1", "cuda", 1), ("cpu2", "cpu", 2)):
        eng, toks, launched, _ = _engine_run(api, model if where == "cuda" else cpu_model, where,
                                             chunk, model_shards=n)
        runs[label] = (eng, toks, launched)
    e2, t2, l2 = runs["card2"]
    e1, t1, l1 = runs["card1"]
    ec, _, _ = runs["cpu2"]
    assert e2.live_counters() == ec.live_counters() == e1.live_counters()
    strip = lambda st: {**st, "device_tiering": {k: v for k, v in st["device_tiering"].items()
                                                 if not k.startswith("shard") and k not in
                                                 ("lookups", "dispatches", "host_syncs", "drains",
                                                  "dispatches_per_step", "host_syncs_per_step")}}
    assert e2.stats()["device_tiering"] == ec.stats()["device_tiering"]
    assert strip(e2.stats()) == strip(e1.stats())
    assert torch.equal(t2, t1)
    assert e2.engine_steps <= l2["tiered_segmented"] <= 2 * e2.engine_steps



# ---------------------------------------------------------------------------
# training: B5's softmax stats, the attention Function, and the wrappers'
# refusal of autograd


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hq,hkv,d,lq,lk,q_offset", [(15, 5, 64, 512, 512, 0), (16, 2, 128, 130, 200, 70),
                                                     (4, 4, 64, 1, 77, 76), (3, 1, 64, 700, 700, 0)])
def test_flash_lse_against_plain(attn, dtype, hq, hkv, d, lq, lk, q_offset):
    """B5 asked for its stats: the output is the launch without them bit
    for bit, and the lse (B, Hq, Lq) f32 is the plain version's within 1e-4
    (both m + log(l) over the same f32 scores; the kernel's exponentials on
    the special-function unit, 2^-22 each)."""
    fa, _ = attn
    q = _randn((2, hq, lq, d), 7, dtype)
    k, v = _randn((2, hkv, lk, d), 8, dtype), _randn((2, hkv, lk, d), 9, dtype)
    kw = dict(causal=True, lk_valid=lk, q_offset=q_offset)
    before = fa.LAUNCHES["flash_attention"]
    out, lse = fa.flash_attention(q, k, v, **kw, return_lse=True)
    bare = fa.flash_attention(q, k, v, **kw)
    plain, plain_lse = fa.flash_attention_ref(q, k, v, **kw, return_lse=True)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] - before == 2
    assert torch.equal(out, bare)
    _close(out, plain)
    assert lse.shape == (2, hq, lq) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, plain_lse, rtol=0, atol=1e-4)


@pytest.mark.parametrize("b,lq,q_offset", [(2, 1024, 1024), (4, 512, 1536)], ids=["rank1of2", "rank3of4"])
def test_flash_lse_at_sequence_parallel_rows(attn, b, lq, q_offset):
    """B5 with its stats at a rank's rows of a sequence split across cards
    (``sp_activations``): qwen1.5-110b's 64/8 heads of 128 over a causal
    2,048, the rows of rank 1 of 2 and of rank 3 of 4 (``q_offset`` the
    rank's first row), bf16. The output and lse are the plain version's
    (one bf16 step; 1e-4), and the same rows of the whole sequence's
    launch (its causal mask and lse at the rows' global positions)."""
    fa, _ = attn
    lk, hq, hkv, d = 2048, 64, 8, 128
    q = _randn((b, hq, lk, d), 17, torch.bfloat16)
    k, v = _randn((b, hkv, lk, d), 18, torch.bfloat16), _randn((b, hkv, lk, d), 19, torch.bfloat16)
    rows = q[:, :, q_offset:q_offset + lq]
    kw = dict(causal=True, lk_valid=lk, q_offset=q_offset)
    out, lse = fa.flash_attention(rows, k, v, **kw, return_lse=True)
    plain, plain_lse = fa.flash_attention_ref(rows, k, v, **kw, return_lse=True)
    whole, whole_lse = fa.flash_attention(q, k, v, causal=True, lk_valid=lk, q_offset=0, return_lse=True)
    torch.cuda.synchronize()
    _close(out, plain)
    torch.testing.assert_close(lse, plain_lse, rtol=0, atol=1e-4)
    _close(out, whole[:, :, q_offset:q_offset + lq])
    torch.testing.assert_close(lse, whole_lse[:, :, q_offset:q_offset + lq], rtol=0, atol=1e-4)


def _wrapper_cases():
    from repro_torch.kernels import (flash_attention as fa, mamba2_scan, paged_attention as pa,
                                     rwkv6_scan, tiered_gather)

    def flash(r):
        return [r(1, 4, 64, 64), r(1, 2, 64, 64), r(1, 2, 64, 64)], lambda q, k, v: fa.flash_attention(q, k, v)

    def paged(r):
        def fn(q, kc, vc):
            kp, vp, table = pa.cache_as_pages(kc, vc, 16)
            return pa.paged_attention(q, kp, vp, table, torch.tensor([5, 32], dtype=torch.int32, device="cuda"))
        return [r(2, 4, 64), r(2, 2, 32, 64), r(2, 2, 32, 64)], fn

    def wkv6(r):
        return ([r(1, 8, 2, 16), r(1, 8, 2, 16), r(1, 8, 2, 16), -r(1, 8, 2, 16).abs(), r(2, 16)],
                lambda *a: rwkv6_scan.wkv6_chunked(*a))

    def ssd(r):
        return ([r(1, 8, 2, 16), r(1, 8, 2).abs(), -r(2).abs(), r(1, 8, 16), r(1, 8, 16), r(2)],
                lambda *a: mamba2_scan.ssd_chunked(*a))

    ids = lambda: torch.tensor([0, 5, 2, 9], dtype=torch.int32, device="cuda")
    maps = lambda: (torch.tensor([0] * 4 + [1] * 12, dtype=torch.int32, device="cuda"),
                    torch.tensor(list(range(16)), dtype=torch.int32, device="cuda"))
    cold = lambda: torch.zeros((16, 24), dtype=torch.int8, device="cuda")

    def gather(r):
        return [r(16, 24)], lambda src: tiered_gather.gather_rows(src, ids())

    def lookup(r):
        return [r(4, 24)], lambda hot: tiered_gather.tiered_lookup_counted(hot, cold(), r(16), *maps(), ids())

    def segments(r):
        seg = lambda: torch.tensor([0, 0, 1, 1], dtype=torch.int32, device="cuda")
        return [r(4, 24)], lambda hot: tiered_gather.tiered_lookup_segments(hot, cold(), r(16), *maps(), ids(),
                                                                          seg(), 2)

    return {"flash_attention": flash, "paged_attention": paged, "wkv6": wkv6, "ssd": ssd,
            "gather_rows": gather, "tiered_lookup_counted": lookup, "tiered_lookup_segments": segments}


@pytest.mark.parametrize("name", ["flash_attention", "paged_attention", "wkv6", "ssd", "gather_rows",
                                  "tiered_lookup_counted", "tiered_lookup_segments"])
def test_kernel_wrappers_refuse_inputs_that_require_grad(card, name):
    """A kernel records no autograd history, so under grad mode an input
    that requires grad raises and launches nothing; without grad, or with
    no input requiring it, the same call launches."""
    from repro_torch.kernels import launch_counts

    g = torch.Generator().manual_seed(11)
    r = lambda *shape: torch.randn(*shape, generator=g).cuda()
    inputs, fn = _wrapper_cases()[name](r)
    before = sum(launch_counts().values())
    inputs[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="requires grad"):
        fn(*inputs)
    assert sum(launch_counts().values()) == before
    with torch.no_grad():
        fn(*inputs)
    inputs[0].requires_grad_(False)
    fn(*inputs)
    torch.cuda.synchronize()
    assert sum(launch_counts().values()) == before + 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hq,hkv,d,n,block_k", [(15, 5, 64, 300, 64), (4, 2, 128, 130, 256), (3, 1, 64, 64, 16)])
def test_attention_fn_on_the_card_against_autograd_through_eager(attn, dtype, hq, hkv, d, n, block_k):
    """AttentionFn on the card (B5 with its stats forward, the reference's
    backward in plain PyTorch) against autograd through the plain eager
    ``attention_chunked`` on the card. Both compute in f32 from the same
    inputs: in f32 the kernel's TF32 products keep 21-22 bits, 2e-5 on the
    outputs; in bf16 the forward's output and the backward's products'
    operands round to bf16, where the eager attention also rounds p before
    PV: held at the bf16 tolerance of the model tests, 2e-2."""
    fa, _ = attn
    from repro_torch.models import common

    g = torch.Generator().manual_seed(12)
    r = lambda *shape: torch.randn(*shape, generator=g).to(dtype).cuda()
    base = [r(2, hq, n, d), r(2, hkv, n, d), r(2, hkv, n, d)]
    dout = r(2, hq, n, d)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    got_in = [t.clone().requires_grad_(True) for t in base]
    before = fa.LAUNCHES["flash_attention"]
    out = common.attention_train(*got_in, causal=True, block_k=block_k)
    assert fa.LAUNCHES["flash_attention"] - before == 1
    got = torch.autograd.grad(out, got_in, dout)
    want_in = [t.clone().requires_grad_(True) for t in base]
    ref = common.attention_chunked(*want_in, causal=True, block_k=block_k)
    want = torch.autograd.grad(ref, want_in, dout)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] - before == 1  # the eager reference launches nothing
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == dtype and bool(torch.isfinite(a).all()), name
        scale = float(b.float().abs().max())
        torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol * scale, msg=f"d{name}")


# ---------------------------------------------------------------------------
# training the recurrent families and whisper: the scans' chunk-entry
# states, WKV6Fn and SSDFn, and B5's stats at whisper's non-causal shapes


# (T, cluster split): one token takes the decode path, which does not split
STATE_CASES = [(1, 1)] + [(t, n) for t in (20, 300) for n in (1, 2, 3, 8)]


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("t,n_split", STATE_CASES)
def test_wkv6_chunk_states_against_plain(scans, t, n_split, state):
    """B6 asked for its chunk-entry states (B, H, C, hd, hd): y and the final
    state bit-equal to the launch without them, the states within the scans'
    tolerance of the plain version's, at every cluster split (a split block
    adds the fold's correction to the states it wrote), a ragged last chunk,
    one token (the decode path), zero and given states."""
    wkv, _ = scans
    from repro_torch.kernels.rwkv6_scan import ops

    args = _wkv6_args(120 + t + n_split, 2, t, 3, 64, True, state)
    before = wkv.LAUNCHES["wkv6"]
    y, s, states = ops._launch(*args, None, n_split, return_states=True)
    bare = ops._launch(*args, None, n_split)
    plain = wkv.wkv6_ref(*args, return_states=True)
    torch.cuda.synchronize()
    assert wkv.LAUNCHES["wkv6"] - before == 2
    assert torch.equal(y, bare[0]) and torch.equal(s, bare[1])
    assert states.shape == (2, 3, -(-t // 32), 64, 64)
    _scan_close((y, s, states), plain)


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("t,n_split", STATE_CASES)
def test_ssd_chunk_states_against_plain(scans, t, n_split, state):
    """B7 asked for its chunk-entry states (b, H, C, P, N), as B6 above."""
    _, ssd = scans
    from repro_torch.kernels.mamba2_scan import ops

    args = _ssd_args(130 + t + n_split, 2, t, 3, 64, 64, True, state)
    before = ssd.LAUNCHES["ssd"]
    y, s, states = ops._launch(*args, None, n_split, return_states=True)
    bare = ops._launch(*args, None, n_split)
    plain = ssd.ssd_ref(*args, return_states=True)
    torch.cuda.synchronize()
    assert ssd.LAUNCHES["ssd"] - before == 2
    assert torch.equal(y, bare[0]) and torch.equal(s, bare[1])
    assert states.shape == (2, 3, -(-t // 32), 64, 64)
    _scan_close((y, s, states), plain)


def _grads_card_and_cpu(fn, inputs, seed):
    """fn's outputs and the gradients of a fixed random projection of them,
    on the card and on the CPU from the same inputs."""
    out = {}
    for dev in ("cuda", "cpu"):
        ins = [None if x is None else x.to(dev).clone().requires_grad_(True) for x in inputs]
        res = fn(*ins)
        g = torch.Generator().manual_seed(seed)
        cot = [torch.randn(r.shape, generator=g).to(dev) for r in res]
        given = [x for x in ins if x is not None]
        out[dev] = ([r.detach().cpu() for r in res],
                    [d.cpu() for d in torch.autograd.grad(res, given, cot)])
    return out["cuda"], out["cpu"]


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("t", [45, 300])
def test_scan_functions_on_the_card_against_the_cpu(scans, t, state):
    """WKV6Fn and SSDFn on the card (B6 / B7 with their states, the chunked
    VJP in plain PyTorch on the card) against the same Functions on the CPU
    (the sequential plain forward): outputs within the scans' tolerance,
    each gradient within 1e-4 of its scale; one kernel launch a forward, none
    in the backward."""
    wkv, ssd = scans
    cases = [(wkv.wkv6_train, _wkv6_args(140 + t, 2, t, 3, 64, True, state), "wkv6"),
             (ssd.ssd_train, _ssd_args(150 + t, 2, t, 3, 64, 64, True, state), "ssd")]
    for fn, args, name in cases:
        counts = wkv.LAUNCHES if name == "wkv6" else ssd.LAUNCHES
        before = counts[name]
        (out, grads), (out_cpu, grads_cpu) = _grads_card_and_cpu(fn, [a.cpu() if a is not None else None
                                                                       for a in args], 160 + t)
        torch.cuda.synchronize()
        assert counts[name] - before == 1, name
        _scan_close(out, out_cpu)
        for i, (a, b) in enumerate(zip(grads, grads_cpu)):
            assert bool(torch.isfinite(a).all()), (name, i)
            torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * float(b.abs().max()), msg=f"{name} grad {i}")


def test_scan_wrappers_refuse_grad_but_their_functions_take_it(scans):
    """Outside the Functions the wrappers still refuse an input that requires
    grad under grad mode, with or without chunk states; the Functions take
    the same inputs."""
    wkv, ssd = scans
    args = _wkv6_args(170, 1, 40, 2, 16, False, False)[:5]
    args[0].requires_grad_(True)
    for kw in ({}, {"return_states": True}):
        with pytest.raises(RuntimeError, match="requires grad"):
            wkv.wkv6_chunked(*args, **kw)
    assert wkv.wkv6_train(*args)[0].requires_grad
    sargs = _ssd_args(171, 1, 40, 2, 16, 16, False, False)[:6]
    sargs[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="requires grad"):
        ssd.ssd_chunked(*sargs, return_states=True)
    assert ssd.ssd_train(*sargs)[0].requires_grad


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("lq,lk", [(1500, 1500), (300, 1500), (4096, 1500), (100, 1500)])
def test_flash_lse_non_causal_at_whisper_shapes(attn, dtype, lq, lk):
    """B5's stats at whisper's training sites, 8/8 heads of 64, non-causal
    over 1500 frames (23 key tiles of 64 and a ragged one of 28): the
    encoder (Lq = Lk) and the cross-attention (Lq != Lk): the output the
    launch without stats bit for bit and within its tolerance of the plain
    version, the lse within 1e-4 of the plain version's."""
    fa, _ = attn
    q = _randn((2, 8, lq, 64), 20 + lq, dtype)
    k, v = _randn((2, 8, lk, 64), 21, dtype), _randn((2, 8, lk, 64), 22, dtype)
    kw = dict(causal=False, lk_valid=lk, q_offset=0)
    out, lse = fa.flash_attention(q, k, v, **kw, return_lse=True)
    bare = fa.flash_attention(q, k, v, **kw)
    plain, plain_lse = fa.flash_attention_ref(q, k, v, **kw, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, bare)
    _close(out, plain)
    torch.testing.assert_close(lse, plain_lse, rtol=0, atol=1e-4)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-1.2b", "whisper-base"])
def test_reduced_training_on_the_card_against_the_cpu(card, arch):
    """One loss and every gradient of a reduced model at the kernels' head
    dims (attention head_dim 64; the scans' reduced 16) on the card against
    the CPU, from the same seed-0 weights and batch (whisper over 100
    frames: a ragged key tile): the loss within 1e-5, each leaf within 1e-4
    of its scale; B5, B6 and B7 launched as ``train_kernel_launches`` says."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.models.api import get_model, train_kernel_launches, trainable

    cfg = get_config(arch).reduced()
    if arch == "zamba2-1.2b":
        cfg = dataclasses.replace(cfg, d_model=128, n_heads=2, n_kv_heads=2, n_layers=5)
    if arch == "whisper-base":
        cfg = dataclasses.replace(cfg, d_model=128, n_heads=2, n_kv_heads=2, n_audio_frames=100)
    api = get_model(cfg)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 70)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (2, 70)).astype(np.int32)}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal((2, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    res = {}
    for dev in ("cuda", "cpu"):
        model = api.init(0, device=dev)
        named = trainable(model)
        for p in named.values():
            p.requires_grad_(True)
        before = launch_counts()
        loss, _ = api.loss(model, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True, materialize_grads=True)
        after = launch_counts()
        res[dev] = (float(loss.detach()), {n: g.cpu() for n, g in zip(named, grads)},
                    {k: after[k] - before[k] for k in ("flash_attention", "wkv6", "ssd")})
    (lg, gg, ng), (lc, gc, nc) = res["cuda"], res["cpu"]
    want = train_kernel_launches(cfg, 1)
    assert ng == {k: want[k] for k in ng} and not any(nc.values()), (ng, want)
    assert abs(lg - lc) <= 1e-5 * abs(lc), (lg, lc)
    for n in gc:
        scale = float(gc[n].abs().max())
        torch.testing.assert_close(gg[n], gc[n], rtol=0, atol=1e-4 * scale + 1e-12, msg=n)


# ---------------------------------------------------------------------------
# the trainer side: checkpoints, a bitwise crash-resume and the Trainer on the card


def test_checkpoint_of_card_state_round_trips(card, tmp_path):
    """A trainer's state on the card (reduced smollm at head_dim 64, random
    moments, step 7) saved in the background and restored into another
    model's state: every leaf bit-equal and on the card, written in place."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.models.api import get_model, trainable
    from repro_torch.optim import adamw_init

    api = get_model(_card_cfg("smollm-360m"))
    model = api.init(0, device="cuda")
    state = adamw_init(trainable(model))
    g = torch.Generator(device="cuda").manual_seed(0)
    for k in ("m", "v"):
        for t in state[k].values():
            t.normal_(generator=g)
    state["step"].fill_(7)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(7, (model, state), {"step": 7})
    mgr.wait()
    other = api.init(1, device="cuda")
    template = (other, adamw_init(trainable(other)))
    params = list(other.parameters())
    (got, got_state), extras = mgr.restore(template)
    assert extras == {"step": 7} and got is other and all(a is b for a, b in zip(params, other.parameters()))
    want = model.state_dict()
    for name, t in got.state_dict().items():
        assert t.device.type == "cuda" and torch.equal(t, want[name]), name
    for k in ("m", "v"):
        for name, t in got_state[k].items():
            assert t.device.type == "cuda" and torch.equal(t, state[k][name]), (k, name)
    assert got_state["step"].device.type == "cuda" and int(got_state["step"]) == 7


# the reference's test_crash_resume_bitwise on the card, in a child process
# that runs deterministic algorithms (cuBLAS's deterministic workspace must
# be in its environment before CUDA starts)
CRASH_RESUME = """
import dataclasses, sys, tempfile, torch
torch.use_deterministic_algorithms(True)
from repro_torch.configs import get_config
from repro_torch.data import SyntheticCorpus, token_batches
from repro_torch.kernels import launch_counts
from repro_torch.models.api import get_model
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.trainer import SimulatedFailure, Trainer, TrainerConfig

cfg = dataclasses.replace(get_config("smollm-360m").reduced(), d_model=192, n_heads=3, n_kv_heads=1)
corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, seq_len=64)
mk = lambda d: Trainer(get_model(cfg), AdamWConfig(lr=1e-3), TrainerConfig(ckpt_dir=d, ckpt_every=3), device="cuda")
with tempfile.TemporaryDirectory() as tmp:
    a = mk(tmp + "/a")
    a.init_state()
    try:
        a.run(token_batches(corpus, 8), 9, fail_at=5)
        sys.exit("no crash")
    except SimulatedFailure:
        a.ckpt.wait()
    b = mk(tmp + "/a")
    assert b.try_restore() and b.step == 3, b.step
    b.run(token_batches(corpus, 8, start_step=b.step), 9 - b.step)
    c = mk(tmp + "/b")
    c.init_state()
    before = launch_counts()["flash_attention"]
    c.run(token_batches(corpus, 8), 9)
    flash = launch_counts()["flash_attention"] - before
leaves = [(f"params.{n}", t, c.params.state_dict()[n]) for n, t in b.params.state_dict().items()]
for k in ("m", "v"):
    leaves += [(f"{k}.{n}", t, c.opt_state[k][n]) for n, t in b.opt_state[k].items()]
leaves.append(("step", b.opt_state["step"], c.opt_state["step"]))
unequal = [n for n, x, y in leaves if x.device.type != "cuda" or not torch.equal(x, y)]
assert not unequal and int(c.opt_state["step"]) == 9, unequal
assert [m["loss"] for m in b.metrics_log] == [m["loss"] for m in c.metrics_log[3:]]
print("bitwise", len(leaves), "flash", flash)
"""


def test_crash_resume_on_the_card_is_bitwise(card):
    """Reduced smollm at head_dim 64 (B5 in every forward): a crash after
    step 5, a restore of step 3 and a resume to step 9 give every
    parameter and AdamW leaf of a clean run, ``torch.equal``."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8", PYTHONPATH=str(root / "src"))
    out = subprocess.run([sys.executable, "-c", CRASH_RESUME], env=env, cwd=root, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    words = out.stdout.split()
    assert words[:2] == ["bitwise", "61"] and int(words[3]) == 9 * 2 * 2, out.stdout  # B5: 2 layers, remat


def test_trainer_on_the_card_follows_the_cpu(card, tmp_path):
    """The Trainer on the card against the Trainer on the CPU, 3 steps of
    reduced smollm at head_dim 64 from the same seed-0 weights and batches.
    Step 1 holds the card's loss and gradients to the CPU's as phase 8 of
    ``chip_smoke.py`` does (B5's three TF32 products and other summation
    orders): loss and accuracy within 1e-5 relative (``TRAIN_LOSS_RTOL``),
    the gradient norm and AdamW's first moment (a scaled gradient) within
    1e-4 of their scale (``TRAIN_GRAD_TOL``), the second moment (a square)
    within 2e-4. The losses of steps 2 and 3 within 1e-4 relative: after
    the first update the parameters differ by up to 2 lr on the elements
    whose gradient lies within that noise of zero (AdamW's step is
    sign-like), which moves the loss by their gradients times 2 lr, some
    1e-6 of it. B5 launched ``train_kernel_launches`` times a step on the
    card, never on the CPU."""
    from repro_torch.data import SyntheticCorpus, token_batches
    from repro_torch.kernels import launch_counts
    from repro_torch.models.api import get_model, train_kernel_launches
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = _card_cfg("smollm-360m")
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, seq_len=64)
    runs = {}
    for dev in ("cuda", "cpu"):
        tr = Trainer(get_model(cfg), AdamWConfig(lr=1e-3), TrainerConfig(ckpt_dir=str(tmp_path / dev)), device=dev)
        tr.init_state(0)
        moments, launched = {}, []
        last = [launch_counts()["flash_attention"]]

        def on_step(step, m, tr=tr, moments=moments, launched=launched, last=last):
            now = launch_counts()["flash_attention"]
            launched.append(now - last[0])
            last[0] = now
            if step == 1:
                moments.update({k: {n: t.cpu() for n, t in tr.opt_state[k].items()} for k in ("m", "v")})

        log = tr.run(token_batches(corpus, 8), 3, on_step=on_step)
        runs[dev] = (log, moments, launched)
    (lg, mg, ng), (lc, mc, nc) = runs["cuda"], runs["cpu"]
    assert ng == [train_kernel_launches(cfg, 1)["flash_attention"]] * 3 and nc == [0, 0, 0], (ng, nc)
    for k in ("loss", "accuracy"):
        assert abs(lg[0][k] - lc[0][k]) <= 1e-5 * max(abs(lc[0][k]), 1.0), (k, lg[0][k], lc[0][k])
    assert abs(lg[0]["grad_norm"] - lc[0]["grad_norm"]) <= 1e-4 * lc[0]["grad_norm"]
    for k, tol in (("m", 1e-4), ("v", 2e-4)):
        for n, t in mc[k].items():
            scale = float(t.abs().max())
            torch.testing.assert_close(mg[k][n], t, rtol=0, atol=tol * scale + 1e-30, msg=f"{k} {n}")
    for i in (1, 2):
        assert abs(lg[i]["loss"] - lc[i]["loss"]) <= 1e-4 * abs(lc[i]["loss"]), (i, lg[i]["loss"], lc[i]["loss"])


# ---------------------------------------------------------------------------
# the sharded engine across cards: NCCL ranks, one card each (2 cards; the
# 4-rank cases need 4), against the same mesh engine on gloo ranks on the CPU


MESH_ARCHS = ("qwen2.5-3b", "qwen1.5-110b", "granite-moe-3b-a800m", "qwen2-moe-a2.7b", "qwen2-vl-7b", "rwkv6-7b",
              "zamba2-1.2b", "whisper-base")


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards < 2:
        pytest.skip("needs 2 CUDA devices: the mesh spans cards")
    import _torch_mesh_ranks as ranks

    world = 4 if n_cards >= 4 else 2
    tmp = tmp_path_factory.mktemp("mesh")
    archs = dict.fromkeys(MESH_ARCHS)
    card = ranks.spawn(ranks.engine_run, world, str(tmp / "card"), archs, True, backend="nccl")
    cpu = ranks.spawn(ranks.engine_run, world, str(tmp / "cpu"), archs, True, backend="gloo")
    return world, card, cpu


@pytest.mark.parametrize("arch", MESH_ARCHS)
@pytest.mark.parametrize("n", [2, 4])
def test_mesh_engine_on_cards_against_the_cpu(mesh_runs, arch, n):
    """Reduced qwen2.5-3b (4/2 heads: over 4 cards each card's query heads
    read one of the 2 replicated KV heads), qwen1.5-110b (4/4, QKV bias),
    and one or two models of every other family (the moe pair TP-for-MoE,
    qwen2-vl's embeds input, rwkv6's B6 and zamba2's B7 on each card's
    heads, whisper's encoder and cross-attention), attention at head_dim 64
    (``card_widths``), over n cards: B5 and B4 run on each card's local
    heads, B6 and B7 on its local heads, B1 and the verify probe's B3 on
    each card's own store shard, and the tokens, books and merged planes
    are the CPU mesh's (the plain versions), on every rank; the prefill
    logits within 1e-4 of their scale."""
    world, card, cpu = mesh_runs
    if n > world:
        pytest.skip(f"needs {n} CUDA devices")
    from repro_torch.configs import get_config
    from repro_torch.models.api import card_widths, kernel_launches

    cfg = card_widths(get_config(arch).reduced())
    for rank in range(n):
        got, want = card[rank][(arch, n, 0)], cpu[rank][(arch, n, 0)]
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        assert got["stats"] == want["stats"] and got["live"] == want["live"]
        for plane in ("near", "far", "slot", "tenant", "role"):
            np.testing.assert_array_equal(got["merged"][plane], want["merged"][plane], err_msg=plane)
        scale = float(np.abs(want["logits"]).max())
        assert float(np.abs(got["logits"] - want["logits"]).max()) <= 1e-4 * scale
        prefills, decodes = got["dispatches"]
        launched = got["launches"]
        expected = kernel_launches(cfg, prefills, decodes)
        assert {k: launched[k] for k in expected} == expected, (launched, expected)
        assert launched["tiered_segmented"] == sum(b for _, b in got["steps"]) > 0
        # the verify probe reads this rank's own slice: B3 once a B1 launch
        assert launched["gather_rows"] == launched["tiered_segmented"]
        assert sum(want["launches"].values()) == 0
        print(f"mesh {arch} over {n} cards, rank {rank}: launches {launched}, "
              f"{len(got['steps'])} steps, {prefills} prefills, {decodes} decodes")
    assert sum(sum(b for _, b in card[r][(arch, n, 0)]["steps"]) for r in range(n)) == \
        card[0][(arch, n, 0)]["stats"]["device_tiering"]["dispatches"]
