"""The port's flash-attention op (its plain PyTorch version on the CPU) against
the JAX package's op (the Pallas kernel in interpret mode) and its oracle,
on the same inputs made with numpy from a seed.

The sweep is the JAX package's own (``tests/test_kernels.py``): GQA groups
of 1, 4 and 3, square and ragged lengths, f32 and bf16, causal and not.
Tolerances are the JAX tests': 2e-5 in f32 (the two sum in other orders),
2e-2 in bf16 (the output rounds to bf16). The kernel's ``lk_valid`` and
``q_offset`` arguments are held against the JAX kernel called with them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels.flash_attention.kernel import flash_attention_kernel as jax_kernel  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as jax_op  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_ref  # noqa: E402
from repro_torch.kernels.flash_attention import LAUNCHES, flash_attention, flash_attention_ref  # noqa: E402

TOL = {"f32": 2e-5, "bf16": 2e-2}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, b, hq, hkv, lq, lk, d, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, lq, d), (b, hkv, lk, d), (b, hkv, lk, d))]
    jdt, tdt = DTYPES[dtype]
    return [jnp.asarray(a).astype(jdt) for a in arrs], [torch.from_numpy(a).to(tdt) for a in arrs]


def _close(a_torch, b_jax, tol):
    a = a_torch.float().numpy()
    b = np.asarray(jnp.asarray(b_jax, jnp.float32))
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("lq,lk", [(128, 128), (96, 160)])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (15, 5)])
def test_flash_attention_against_jax(hq, hkv, lq, lk, dtype, causal):
    (qj, kj, vj), (qt, kt, vt) = _inputs(0, 2, hq, hkv, lq, lk, 64, dtype)
    out = flash_attention(qt, kt, vt, causal=causal)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    plain = flash_attention_ref(qt, kt, vt, causal=causal)
    assert torch.equal(out, plain)  # on the CPU the op is its plain version
    _close(out, jax_ref(qj, kj, vj, causal=causal), TOL[dtype])
    _close(out, jax_op(qj, kj, vj, causal=causal, block_q=64, block_k=64), TOL[dtype])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("lk_valid,q_offset", [(100, None), (70, 6), (128, 0)])
def test_lk_valid_and_q_offset_against_the_jax_kernel(lk_valid, q_offset, causal):
    """Keys past lk_valid masked, the causal diagonal shifted by q_offset
    (default lk_valid - Lq), as the Pallas kernel called with them."""
    (qj, kj, vj), (qt, kt, vt) = _inputs(3, 1, 8, 2, 64, 128, 64, "f32")
    out = flash_attention(qt, kt, vt, causal=causal, lk_valid=lk_valid, q_offset=q_offset)
    ref = jax_kernel(qj, kj, vj, causal=causal, block_q=32, block_k=32, lk_valid=lk_valid,
                     q_offset=q_offset, interpret=True)
    _close(out, ref, TOL["f32"])
    # masked keys are not read: garbage past lk_valid changes nothing
    kt2, vt2 = kt.clone(), vt.clone()
    kt2[:, :, lk_valid:] = 1e4
    vt2[:, :, lk_valid:] = -1e4
    out2 = flash_attention(qt, kt2, vt2, causal=causal, lk_valid=lk_valid, q_offset=q_offset)
    assert torch.equal(out, out2)


def test_the_model_call_is_the_reference_at_full_prefill():
    """What the model passes (lk_valid = L, q_offset = 0) is the default."""
    _, (qt, kt, vt) = _inputs(4, 1, 15, 5, 40, 40, 64, "f32")
    assert torch.equal(flash_attention(qt, kt, vt, causal=True, lk_valid=40, q_offset=0),
                       flash_attention(qt, kt, vt, causal=True))


def test_strided_views_go_in_as_they_are():
    """The model hands in transpose(1, 2) views of its projections."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 24, 3 * 128)).astype(np.float32))
    q = x.reshape(2, 24, 3, 128).transpose(1, 2)
    k = x[:, :, :128].reshape(2, 24, 1, 128).transpose(1, 2)
    assert not q.is_contiguous()
    assert torch.equal(flash_attention(q, k, k), flash_attention(q.contiguous(), k.contiguous(),
                                                                 k.contiguous()))


def test_argument_checks_raise():
    _, (q, k, v) = _inputs(6, 1, 4, 2, 16, 16, 64, "f32")
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="head_dim 32"):
        flash_attention(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(ValueError, match="group"):
        flash_attention(q[:, :3], k, v)
    with pytest.raises(ValueError, match="k and v"):
        flash_attention(q, k, v[:, :, :8])
    assert LAUNCHES["flash_attention"] == 0  # nothing here launches a kernel
