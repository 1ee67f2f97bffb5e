"""The port's paged decode-attention op (its plain PyTorch version on the CPU)
against the JAX package's op (the Pallas kernel in interpret mode) and its
oracle, on the same inputs made with numpy from a seed; and the view that
hands the model's per-slot cache to the op as pages, without a copy.

The sweep is the JAX package's own (``tests/test_kernels.py``), at its
tolerance of 2e-5 (f32; the two sum in other orders). The cache view must
gather back to the cache bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels.paged_attention.ops import paged_attention as jax_op  # noqa: E402
from repro.kernels.paged_attention.ref import gather_pages as jax_gather  # noqa: E402
from repro.kernels.paged_attention.ref import paged_attention_ref as jax_ref  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    LAUNCHES,
    cache_as_pages,
    gather_pages,
    paged_attention,
    paged_attention_ref,
)
from repro_torch.models import common  # noqa: E402

TOL = 2e-5


def _pool(seed, hq, hkv, ps, b=4, d=64, n_phys=32, pp=6):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    kp = rng.standard_normal((hkv, n_phys, ps, d)).astype(np.float32)
    vp = rng.standard_normal((hkv, n_phys, ps, d)).astype(np.float32)
    pt = rng.integers(0, n_phys, (b, pp)).astype(np.int32)
    lengths = np.array([1, ps + 3, 2 * ps, pp * ps], np.int32)[:b]
    return q, kp, vp, pt, lengths


@pytest.mark.parametrize("ps", [16, 32])
@pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 4)])
def test_paged_attention_against_jax(hq, hkv, ps):
    arrs = _pool(1, hq, hkv, ps)
    t = [torch.from_numpy(a) for a in arrs]
    out = paged_attention(*t)
    assert out.dtype == torch.float32 and out.shape == t[0].shape
    assert torch.equal(out, paged_attention_ref(*t))  # on the CPU the op is its plain version
    j = [jnp.asarray(a) for a in arrs]
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_ref(*j)), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_op(*j)), rtol=TOL, atol=TOL)


def test_gather_pages_matches_jax_with_out_of_range_ids():
    """Page ids index as JAX does: negative wraps once, the rest clamps."""
    q, kp, vp, pt, lengths = _pool(2, 8, 2, 16)
    pt[0, :3] = [-1, -40, 99]
    np.testing.assert_array_equal(gather_pages(torch.from_numpy(kp), torch.from_numpy(pt)).numpy(),
                                  np.asarray(jax_gather(jnp.asarray(kp), jnp.asarray(pt))))


def _cache(seed, b=3, hkv=5, s=64, hd=64, layers=2):
    """A model cache (L, B, Hkv, S, hd) in bf16, as the engine holds it."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((layers, b, hkv, s, hd)).astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("ps", [16, 64])
def test_cache_as_pages_is_the_cache_bit_for_bit(ps, layer):
    kc, vc = _cache(3), _cache(4)
    k, v = kc[layer], vc[layer]
    kp, vp, table = cache_as_pages(k, v, ps)
    b, hkv, s, hd = k.shape
    pp = s // ps
    assert kp.shape == (hkv, b * hkv * pp - (hkv - 1) * pp, ps, hd) and table.dtype == torch.int32
    assert kp.untyped_storage().data_ptr() == kc.untyped_storage().data_ptr()  # a view, no copy
    assert torch.equal(table, torch.arange(b, dtype=torch.int32)[:, None] * hkv * pp
                       + torch.arange(pp, dtype=torch.int32))
    assert torch.equal(gather_pages(kp, table), k) and torch.equal(gather_pages(vp, table), v)
    # the pool built explicitly from the view gathers to the same cache
    pool = kp.contiguous()
    assert torch.equal(gather_pages(pool, table), k)
    np.testing.assert_array_equal(
        np.asarray(jax_gather(jnp.asarray(pool.float().numpy()), jnp.asarray(table.numpy()))),
        k.float().numpy())


def test_decode_over_the_view_is_the_models_decode_attention():
    """Lengths of 1, a partial page, a full cache and past the cache's end:
    the op over the view equals the eager decode attention over the cache
    (lengths clamped to S), and the op over an explicit pool."""
    kc, vc = (_cache(seed, b=4, hkv=2, s=64, hd=128, layers=1) for seed in (5, 6))
    k, v = kc[0], vc[0]
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.standard_normal((4, 16, 128)).astype(np.float32)).to(torch.bfloat16)
    lengths = torch.tensor([1, 21, 64, 90], dtype=torch.int32)
    kp, vp, table = cache_as_pages(k, v, 16)
    out = paged_attention(q, kp, vp, table, lengths)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, paged_attention(q, kp.contiguous(), vp.contiguous(), table, lengths))
    eager = common.attention_decode(q.float()[:, :, None], k.float(), v.float(),
                                    lengths.clamp(max=64))[:, :, 0]
    np.testing.assert_allclose(out.float().numpy(), eager.numpy(), rtol=2e-2, atol=2e-2)
    f32 = paged_attention(q.float(), kp, vp, table, lengths)
    np.testing.assert_allclose(f32.numpy(), eager.numpy(), rtol=TOL, atol=TOL)


def test_cache_as_pages_refuses_what_it_cannot_view():
    k = _cache(7)[0]
    with pytest.raises(ValueError, match="pages of 24"):
        cache_as_pages(k, k, 24)
    with pytest.raises(ValueError, match="contiguous"):
        cache_as_pages(k.transpose(2, 3), k.transpose(2, 3), 16)
    with pytest.raises(ValueError, match="caches"):
        cache_as_pages(k, k[:, :1], 16)


def test_argument_checks_raise():
    q, kp, vp, pt, lengths = (torch.from_numpy(a) for a in _pool(8, 8, 2, 16))
    with pytest.raises(ValueError, match="q must be"):
        paged_attention(q.half(), kp, vp, pt, lengths)
    with pytest.raises(ValueError, match="pages must share"):
        paged_attention(q, kp.half(), vp.half(), pt, lengths)
    with pytest.raises(ValueError, match="head_dim 32"):
        paged_attention(q[..., :32], kp[..., :32], vp[..., :32], pt, lengths)
    with pytest.raises(ValueError, match="page_table"):
        paged_attention(q, kp, vp, pt.long(), lengths)
    with pytest.raises(ValueError, match="lengths"):
        paged_attention(q, kp, vp, pt, lengths.long())
    with pytest.raises(ValueError, match="groups of 1..8"):
        paged_attention(torch.cat([q, q, q], dim=1), kp, vp, pt, lengths)
    assert LAUNCHES["paged_attention"] == 0  # nothing here launches a kernel
