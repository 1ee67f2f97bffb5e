"""The f32 flash kernel's algorithm in plain PyTorch
(``flash_attention_tf32_ref``: an online softmax over tiles of 64 keys,
both products as three TF32 products of split operands) against the JAX
package's op (the Pallas kernel in interpret mode) and against the port's
plain version, on the same inputs made with numpy from a seed.

Tolerance: 2e-5 in f32, the JAX tests' own and the card tests'. The split
keeps some 21-22 bits of each product, so the result differs from plain
f32 attention by summation order only; a single TF32 product (11 bits)
misses 2e-5, which is why the kernel takes three.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels.flash_attention.kernel import flash_attention_kernel as jax_kernel  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as jax_op  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_ref,
    flash_attention_tf32_ref,
)
from repro_torch.kernels.flash_attention.ref import tf32_rna  # noqa: E402

TOL = 2e-5


def _inputs(seed, b, hq, hkv, lq, lk, d):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, lq, d), (b, hkv, lk, d), (b, hkv, lk, d))]
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]


def _close(a_torch, b, tol=TOL):
    a = a_torch.numpy()
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape and a.dtype == np.float32, (a.shape, b.shape, a.dtype)
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("lq,lk,d", [(128, 128, 64), (96, 160, 64), (64, 100, 128)])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_tf32_against_jax_and_plain(hq, hkv, lq, lk, d, causal):
    (qj, kj, vj), (qt, kt, vt) = _inputs(1, 2, hq, hkv, lq, lk, d)
    out = flash_attention_tf32_ref(qt, kt, vt, causal=causal)
    assert out.dtype == torch.float32 and out.shape == qt.shape
    _close(out, jax_op(qj, kj, vj, causal=causal, block_q=64, block_k=64))
    _close(out, flash_attention_ref(qt, kt, vt, causal=causal))


@pytest.mark.parametrize("lk_valid,q_offset", [(100, None), (70, 6), (128, 0)])
def test_tf32_lk_valid_and_q_offset_against_the_jax_kernel(lk_valid, q_offset):
    """Keys past lk_valid masked, the diagonal shifted by q_offset, as the
    Pallas kernel called with them; tiles of 64 cut by both."""
    (qj, kj, vj), (qt, kt, vt) = _inputs(3, 1, 8, 2, 64, 128, 64)
    args = dict(causal=True, lk_valid=lk_valid, q_offset=q_offset)
    out = flash_attention_tf32_ref(qt, kt, vt, **args)
    _close(out, jax_kernel(qj, kj, vj, block_q=32, block_k=32, interpret=True, **args))
    _close(out, flash_attention_ref(qt, kt, vt, **args))


def test_tf32_at_zamba2_width_against_plain():
    """zamba2-1.2b's shared block at one prompt of 512 (8 key tiles), two of
    its 32 heads of 64."""
    _, (qt, kt, vt) = _inputs(4, 1, 2, 2, 512, 512, 64)
    _close(flash_attention_tf32_ref(qt, kt, vt, causal=True),
           flash_attention_ref(qt, kt, vt, causal=True))


def test_one_tf32_product_misses_the_tolerance():
    """The split is needed: against plain f32 attention one TF32 product (11
    bits of each operand) misses 2e-5 by far, two (B's small part added)
    still miss it, three hold it."""
    _, (qt, kt, vt) = _inputs(5, 1, 4, 4, 512, 512, 64)
    exact = flash_attention_ref(qt, kt, vt, causal=True)
    errs = [float((flash_attention_tf32_ref(qt, kt, vt, causal=True, products=n) - exact).abs().max())
            for n in (1, 2, 3)]
    assert errs[0] > 10 * TOL and errs[1] > 10 * TOL and errs[2] < TOL / 4, errs


def test_tf32_rna_rounds_to_nearest_ties_away_from_zero():
    """cvt.rna.tf32.f32: 10 mantissa bits kept, the 13 dropped rounded to
    nearest with ties away from zero, in both signs; exact TF32 values and
    zero unchanged."""
    u = 2.0 ** -10  # one TF32 step at 1
    x = torch.tensor([1 + u / 2, 1 + u / 2 - 2 ** -23, 1 + 1.5 * u, -(1 + u / 2), 1 + u, 0.0, -3.0])
    want = torch.tensor([1 + u, 1.0, 1 + 2 * u, -(1 + u), 1 + u, 0.0, -3.0])
    assert torch.equal(tf32_rna(x), want)
    y = torch.from_numpy(np.random.default_rng(6).standard_normal(1000).astype(np.float32))
    big = tf32_rna(y)
    assert bool(((big.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((y - big).abs() <= 2.0 ** -11 * y.abs()).all())
