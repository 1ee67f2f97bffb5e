"""The port's SSD op (its plain PyTorch version on the CPU) against the JAX
package's op (the Pallas kernel in interpret mode) and its oracle, on the
same inputs made with numpy from a seed.

The sweep follows the JAX package's own (``tests/test_kernels.py``), at the
sizes the kernel is built for (P and N of 16, 32, 64): lengths of one
step, a ragged 50, whole chunks of 64 and 96, chunks of 16 and 32, a state
carried across two calls, and strong decays. Tolerance is the JAX tests',
1e-4 in f32: the chunked kernel's closed form and the sequential oracles
round differently.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels.mamba2_scan.ops import ssd_chunked as jax_op  # noqa: E402
from repro.kernels.mamba2_scan.ref import ssd_ref as jax_ref  # noqa: E402
from repro_torch.kernels.mamba2_scan import LAUNCHES, ssd_chunked, ssd_ref  # noqa: E402

TOL = 1e-4


def _inputs(seed, b, t, h, p, n, a_mu=0.0, state=False):
    """x (b, T, H, P), dt (b, T, H) = softplus(N(0, 1)), A (H,) =
    -exp(N(a_mu, 1)), B, C (b, T, N), D (H,), state (b, H, P, N) or None,
    as numpy f32; a_mu = 2 draws decays dt*A of -1 .. -60 a step."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, t, h)))).astype(np.float32)
    a = -np.exp(rng.normal(a_mu, 1.0, h)).astype(np.float32)
    return [f(b, t, h, p), dt, a, f(b, t, n), f(b, t, n), f(h),
            f(b, h, p, n) if state else None]


def _torch(arrs):
    return [None if a is None else torch.from_numpy(a) for a in arrs]


def _jax(arrs):
    return [None if a is None else jnp.asarray(a) for a in arrs]


def _close(a_torch, b_jax):
    a, b = a_torch.numpy(), np.asarray(b_jax)
    assert a.shape == b.shape and a.dtype == np.float32, (a.shape, b.shape, a.dtype)
    np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("t", [1, 50, 64, 96])
def test_ssd_against_jax(t, chunk):
    arrs = _inputs(t, 2, t, 2, 16, 32, state=t % 2 == 0)
    y, s = ssd_chunked(*_torch(arrs))
    yj, sj = jax_op(*_jax(arrs), chunk=chunk, interpret=True)
    _close(y, yj)
    _close(s, sj)
    yr, sr = jax_ref(*_jax(arrs))
    _close(y, yr)
    _close(s, sr)


@pytest.mark.parametrize("p,n", [(64, 16), (32, 64)])
def test_strong_decay_against_the_oracle(p, n):
    arrs = _inputs(7, 1, 40, 3, p, n, a_mu=2.0, state=True)
    y, s = ssd_chunked(*_torch(arrs))
    yr, sr = jax_ref(*_jax(arrs))
    _close(y, yr)
    _close(s, sr)
    yj, sj = jax_op(*_jax(arrs), chunk=16, interpret=True)
    _close(y, yj)
    _close(s, sj)


def test_state_carried_across_two_calls():
    arrs = _inputs(3, 1, 64, 2, 16, 16)
    x, dt, a, bm, cm, d, _ = _torch(arrs)
    y_full, s_full = ssd_chunked(x, dt, a, bm, cm, d)
    y1, s1 = ssd_chunked(x[:, :30], dt[:, :30], a, bm[:, :30], cm[:, :30], d)
    y2, s2 = ssd_chunked(x[:, 30:], dt[:, 30:], a, bm[:, 30:], cm[:, 30:], d, s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(s2.numpy(), s_full.numpy(), rtol=1e-6, atol=1e-6)
    xj, dtj, aj, bj, cj, dj, _ = _jax(arrs)
    _, sj1 = jax_op(xj[:, :30], dtj[:, :30], aj, bj[:, :30], cj[:, :30], dj, chunk=16, interpret=True)
    yj2, sj2 = jax_op(xj[:, 30:], dtj[:, 30:], aj, bj[:, 30:], cj[:, 30:], dj, state=sj1, chunk=16,
                      interpret=True)
    _close(y2, yj2)
    _close(s2, sj2)


def test_cpu_routing_is_the_plain_version_and_inplace_writes_the_state():
    args = _torch(_inputs(4, 2, 9, 2, 16, 16, state=True))
    before = LAUNCHES["ssd"]
    y, s = ssd_chunked(*args)
    yp, sp = ssd_ref(*args)
    assert torch.equal(y, yp) and torch.equal(s, sp)
    cache = args[-1].clone()
    yi, si = ssd_chunked(*args[:-1], cache, inplace=True)
    assert si is cache and torch.equal(cache, sp) and torch.equal(yi, yp)
    assert LAUNCHES["ssd"] == before  # the CPU launches nothing


def test_argument_checks():
    x, dt, a, bm, cm, d, s0 = _torch(_inputs(5, 1, 4, 2, 16, 16, state=True))
    cases = [
        ((x, dt[:, :3], a, bm, cm, d), {}, "dt must be"),
        ((x, dt, a[:1], bm, cm, d), {}, "A and D"),
        ((x, dt, a, bm, cm[:, :, :8], d), {}, "B and C"),
        ((x, dt, a, bm, cm, d, s0[:, :1]), {}, "state must be"),
        ((x, dt.double(), a, bm, cm, d), {}, "float32"),
        ((x[:, :, :, :8], dt, a, bm, cm, d), {}, "not built"),
        ((x[:, :0], dt[:, :0], a, bm[:, :0], cm[:, :0], d), {}, "empty"),
        ((x, dt, a, bm, cm, d), {"inplace": True}, "inplace"),
    ]
    for args, kw, msg in cases:
        with pytest.raises(ValueError, match=msg):
            ssd_chunked(*args, **kw)
    m = lambda t: t.to("meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ssd_chunked(m(x), m(dt), m(a), m(bm), m(cm), m(d))
