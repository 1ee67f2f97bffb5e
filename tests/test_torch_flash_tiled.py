"""The bf16 flash kernel's algorithm in plain PyTorch
(``flash_attention_tiled_ref``: an online softmax over tiles of 64 keys,
p into PV as three bf16 parts) against the JAX package's op (the Pallas
kernel in interpret mode) and against the port's plain version, on the
same inputs made with numpy from a seed.

Tolerances: against JAX the JAX tests' own, 2e-5 in f32 and 2e-2 in bf16
(the output rounds to bf16; the JAX op also rounds p to its v dtype).
Against the port's plain version, which keeps p in f32: 2e-5 in f32 (sums
in other orders) and one bf16 step in bf16 (2**-7 of the value, plus
1e-6): the three parts carry all 24 bits of p, so the f32 results differ
by summation order only.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels.flash_attention.kernel import flash_attention_kernel as jax_kernel  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as jax_op  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_ref,
    flash_attention_tiled_ref,
)

TOL = {"f32": 2e-5, "bf16": 2e-2}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, b, hq, hkv, lq, lk, d, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, lq, d), (b, hkv, lk, d), (b, hkv, lk, d))]
    jdt, tdt = DTYPES[dtype]
    return [jnp.asarray(a).astype(jdt) for a in arrs], [torch.from_numpy(a).to(tdt) for a in arrs]


def _close_jax(a_torch, b_jax, tol):
    a = a_torch.float().numpy()
    b = np.asarray(jnp.asarray(b_jax, jnp.float32))
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


def _close_plain(out, plain):
    assert out.dtype == plain.dtype and out.shape == plain.shape
    a, b = out.float(), plain.float()
    if out.dtype == torch.float32:
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)
    else:
        assert bool(((a - b).abs() <= 2.0 ** -7 * torch.maximum(a.abs(), b.abs()) + 1e-6).all())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("lq,lk,d", [(128, 128, 64), (96, 160, 64), (64, 100, 128)])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (15, 5)])
def test_tiled_against_jax_and_plain(hq, hkv, lq, lk, d, dtype, causal):
    (qj, kj, vj), (qt, kt, vt) = _inputs(0, 2, hq, hkv, lq, lk, d, dtype)
    out = flash_attention_tiled_ref(qt, kt, vt, causal=causal)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    _close_jax(out, jax_op(qj, kj, vj, causal=causal, block_q=64, block_k=64), TOL[dtype])
    _close_plain(out, flash_attention_ref(qt, kt, vt, causal=causal))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("lk_valid,q_offset", [(100, None), (70, 6), (128, 0)])
def test_tiled_lk_valid_and_q_offset_against_the_jax_kernel(lk_valid, q_offset, dtype):
    """Keys past lk_valid masked, the diagonal shifted by q_offset, as the
    Pallas kernel called with them; tiles of 64 cut by both."""
    (qj, kj, vj), (qt, kt, vt) = _inputs(3, 1, 8, 2, 64, 128, 64, dtype)
    args = dict(causal=True, lk_valid=lk_valid, q_offset=q_offset)
    out = flash_attention_tiled_ref(qt, kt, vt, **args)
    ref = jax_kernel(qj, kj, vj, block_q=32, block_k=32, interpret=True, **args)
    _close_jax(out, ref, TOL[dtype])
    _close_plain(out, flash_attention_ref(qt, kt, vt, **args))


@pytest.mark.parametrize("hq,hkv", [(3, 1), (8, 1)])
def test_tiled_ragged_long_prompt_against_plain(hq, hkv):
    """lq = lk = 1000: ragged last tiles at both ends, 16 key tiles."""
    _, (qt, kt, vt) = _inputs(4, 1, hq, hkv, 1000, 1000, 64, "bf16")
    _close_plain(flash_attention_tiled_ref(qt, kt, vt, causal=True),
                 flash_attention_ref(qt, kt, vt, causal=True))


def test_three_parts_carry_p_as_f32():
    """The split is what keeps the kernel at the TPU kernel's f32 p: against
    PV with f32 p, one bf16 part leaves an error of some 2**-9 of the
    output, two some 2**-18, three only f32 summation noise (below 2**-20)."""
    _, (qt, kt, vt) = _inputs(5, 1, 4, 4, 64, 192, 64, "f32")
    qb, kb, vb = (x.to(torch.bfloat16).float() for x in (qt, kt, vt))
    exact = flash_attention_ref(qb, kb, vb, causal=False)  # f32 p, f32 output
    p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", qb, kb) / 8.0, dim=-1)
    scale = float(exact.abs().max())
    errs, pv, rest = [], 0.0, p
    for _ in range(3):
        part = rest.to(torch.bfloat16).float()
        pv = pv + torch.einsum("bhqk,bhkd->bhqd", part, vb)
        rest = rest - part
        errs.append(float((pv - exact).abs().max()) / scale)
    assert errs[0] > 2.0 ** -10 and errs[1] > 4 * errs[2] and errs[2] < 2.0 ** -20, errs
