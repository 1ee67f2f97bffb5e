"""The port's WKV6 op (its plain PyTorch version on the CPU) against the JAX
package's op (the Pallas kernel in interpret mode) and its oracle, on the
same inputs made with numpy from a seed.

The sweep is the JAX package's own (``tests/test_kernels.py``) and more:
lengths of one token, a ragged 50, whole chunks of 64 and 96, chunks of 16
and 32, a state carried across two calls, and strong decays. Tolerance is
the JAX tests', 1e-4 in f32: the chunked kernel's closed form and the
sequential oracles round differently.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels.rwkv6_scan.ops import wkv6_chunked as jax_op  # noqa: E402
from repro.kernels.rwkv6_scan.ref import wkv6_ref as jax_ref  # noqa: E402
from repro_torch.kernels.rwkv6_scan import LAUNCHES, wkv6_chunked, wkv6_ref  # noqa: E402

TOL = 1e-4


def _inputs(seed, b, t, h, hd, decay_mu=0.0, state=False):
    """r, k, v, lw (B, T, H, hd), u (H, hd), state (B, H, hd, hd) or None, as
    numpy f32; lw = -exp(N(decay_mu, 1)), so decay_mu = 1.5 draws decays
    of e^-4 .. e^-100 a step."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    lw = -np.exp(rng.normal(decay_mu, 1.0, (b, t, h, hd))).astype(np.float32)
    return [f(b, t, h, hd), f(b, t, h, hd), f(b, t, h, hd), lw, f(h, hd),
            f(b, h, hd, hd) if state else None]


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
def test_wkv6_against_jax(t, chunk):
    arrs = _inputs(t, 2, t, 2, 16, state=t % 2 == 0)
    y, s = wkv6_chunked(*_torch(arrs))
    yj, sj = jax_op(*_jax(arrs), chunk=chunk, interpret=True)
    _close(y, yj)
    _close(s, sj)
    yr, sr = jax_ref(*_jax(arrs))
    _close(y, yr)
    _close(s, sr)


@pytest.mark.parametrize("hd", [32, 64])
def test_strong_decay_against_the_oracle(hd):
    """Decays of e^-4 and far below: the sequential oracles underflow to
    zero where the closed form takes exp of a large negative exponent."""
    arrs = _inputs(7, 1, 40, 2, hd, decay_mu=1.5, state=True)
    y, s = wkv6_chunked(*_torch(arrs))
    yr, sr = jax_ref(*_jax(arrs))
    _close(y, yr)
    _close(s, sr)
    yj, sj = jax_op(*_jax(arrs), chunk=16, interpret=True)
    _close(y, yj)
    _close(s, sj)


def test_state_carried_across_two_calls():
    """Two calls with the state carried == one call == the JAX op split the same way."""
    arrs = _inputs(3, 1, 64, 2, 16)
    r, k, v, lw, u, _ = _torch(arrs)
    y_full, s_full = wkv6_chunked(r, k, v, lw, u)
    y1, s1 = wkv6_chunked(r[:, :30], k[:, :30], v[:, :30], lw[:, :30], u)
    y2, s2 = wkv6_chunked(r[:, 30:], k[:, 30:], v[:, 30:], lw[:, 30:], u, s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), y_full.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(s2.numpy(), s_full.numpy(), rtol=1e-6, atol=1e-6)
    rj, kj, vj, lwj, uj, _ = _jax(arrs)
    _, sj1 = jax_op(rj[:, :30], kj[:, :30], vj[:, :30], lwj[:, :30], uj, chunk=16, interpret=True)
    yj2, sj2 = jax_op(rj[:, 30:], kj[:, 30:], vj[:, 30:], lwj[:, 30:], uj, state=sj1, chunk=16,
                      interpret=True)
    _close(y2, yj2)
    _close(s2, sj2)


def test_cpu_routing_is_the_plain_version_and_inplace_writes_the_state():
    r, k, v, lw, u, s0 = _torch(_inputs(4, 2, 9, 2, 16, state=True))
    before = LAUNCHES["wkv6"]
    y, s = wkv6_chunked(r, k, v, lw, u, s0)
    yp, sp = wkv6_ref(r, k, v, lw, u, s0)
    assert torch.equal(y, yp) and torch.equal(s, sp)
    cache = s0.clone()
    yi, si = wkv6_chunked(r, k, v, lw, u, cache, inplace=True)
    assert si is cache and torch.equal(cache, sp) and torch.equal(yi, yp)
    assert LAUNCHES["wkv6"] == before  # the CPU launches nothing


def test_argument_checks():
    r, k, v, lw, u, s0 = _torch(_inputs(5, 1, 4, 2, 16, state=True))
    cases = [
        ((r, k, v, lw[:, :3], u), {}, "four"),
        ((r, k, v, lw, u[:1]), {}, "u must be"),
        ((r, k, v, lw, u, s0[:, :1]), {}, "state must be"),
        ((r.double(), k, v, lw, u), {}, "float32"),
        ((r[:, :0], k[:, :0], v[:, :0], lw[:, :0], u), {}, "empty"),
        ((r, k, v, lw, u), {"inplace": True}, "inplace"),
    ]
    for args, kw, msg in cases:
        with pytest.raises(ValueError, match=msg):
            wkv6_chunked(*args, **kw)
    x = torch.zeros(1, 4, 2, 24)
    with pytest.raises(ValueError, match="head_dim 24"):
        wkv6_chunked(x, x, x, x, torch.zeros(2, 24))
    m = lambda a: a.to("meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        wkv6_chunked(m(r), m(k), m(v), m(lw), m(u))
