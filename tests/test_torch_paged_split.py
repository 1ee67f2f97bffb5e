"""The paged decode kernel's algorithm in plain PyTorch
(``paged_attention_split_ref``: the positions split into spans, one
partial a span, merged in split order) against the JAX package's op (the
Pallas kernel in interpret mode) and against the port's plain version, on
the same inputs made with numpy from a seed; and the split count, which
comes from shapes alone.

Tolerances: 2e-5 in f32, the JAX tests' own (the three sum in other
orders); one bf16 step (2**-7 of the value, plus 1e-6) for bf16 outputs.
Lengths are at least 1: a row with no valid key is outside the contract.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels.paged_attention.ops import paged_attention as jax_op  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    cache_as_pages,
    paged_attention_ref,
    paged_attention_split_ref,
    split_count,
)

TOL = 2e-5


def _pool(seed, hq, hkv, ps, lengths, d=64, n_phys=32, pp=6):
    rng = np.random.default_rng(seed)
    b = len(lengths)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    kp = rng.standard_normal((hkv, n_phys, ps, d)).astype(np.float32)
    vp = rng.standard_normal((hkv, n_phys, ps, d)).astype(np.float32)
    pt = rng.integers(-3, n_phys + 3, (b, pp)).astype(np.int32)  # some ids out of range
    return q, kp, vp, pt, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("n_split", [1, 2, 8])
@pytest.mark.parametrize("ps", [16, 32])
@pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 4), (3, 1)])
def test_split_against_jax_and_plain(hq, hkv, ps, n_split):
    """Six pages a sequence: at 8 splits the spans (12 or 24 positions)
    cut pages, a length of 1 leaves seven splits empty, and the last
    length runs past the pool's end."""
    lengths = [1, ps + 3, 2 * ps, 6 * ps - 1, 6 * ps, 6 * ps + 7]
    arrs = _pool(1, hq, hkv, ps, lengths)
    t = [torch.from_numpy(a) for a in arrs]
    out = paged_attention_split_ref(*t, n_split=n_split)
    assert out.dtype == torch.float32 and out.shape == t[0].shape
    np.testing.assert_allclose(out.numpy(), paged_attention_ref(*t).numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_op(*(jnp.asarray(a) for a in arrs))),
                               rtol=TOL, atol=TOL)


def test_split_count_comes_from_shapes():
    """Doubled up to the 8 blocks of a portable cluster while the grid is
    under 512 blocks, spans of at least 64 positions."""
    assert [split_count(c, 2, 8) for c in (16, 64, 127, 128, 256, 1024, 65536)] == [1, 1, 1, 2, 4, 8, 8]
    # the main paths' decode over a cache of 1024: qwen2.5-3b (2 KV heads,
    # 8 slots) from 16 blocks to 128, smollm-360m (5) from 40 to 320,
    # zamba2-1.2b (32) from 256 to 512
    assert [n * 8 * split_count(1024, n, 8) for n in (2, 5, 32)] == [128, 320, 512]
    assert split_count(1024, 64, 8) == 1


@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
def test_split_over_the_cache_view_at_main_path_width(q_dtype):
    """The engine's case at S = 1024: 8 splits of 128 over pages of 16;
    lengths 1, a span less one, a span, a span and one, the cache less one,
    the cache, past it."""
    rng = np.random.default_rng(2)
    kc, vc = (torch.from_numpy(rng.standard_normal((8, 2, 1024, 128)).astype(np.float32))
              .to(torch.bfloat16) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((8, 16, 128)).astype(np.float32)).to(q_dtype)
    lengths = torch.tensor([1, 127, 128, 129, 700, 1023, 1024, 1300], dtype=torch.int32)
    kp, vp, table = cache_as_pages(kc, vc, 16)
    n_split = split_count(table.shape[1] * 16, 2, 8)
    assert n_split == 8
    out = paged_attention_split_ref(q, kp, vp, table, lengths, n_split)
    plain = paged_attention_ref(q, kp, vp, table, lengths)
    assert out.dtype == q_dtype
    a, b = out.float(), plain.float()
    if q_dtype == torch.float32:
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)
    else:
        assert bool(((a - b).abs() <= 2.0 ** -7 * torch.maximum(a.abs(), b.abs()) + 1e-6).all())
