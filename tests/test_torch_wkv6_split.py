"""The WKV6 prefill kernel's algorithm in plain PyTorch (``wkv6_split_ref``:
each sequence split over n_split blocks of whole chunks, each block's local
state and per-channel decay folded in block order, the carry of the state
entering a block taken over its exclusive running sum) against the JAX
package's op (the Pallas kernel in interpret mode), its oracle and the
model's own scan (``repro.models.rwkv6.wkv6``), on the same inputs made
with numpy from a seed; and the split rule ``split_count``.

Tolerance: 1e-4 in f32 (``SCAN_RTOL`` of the smoke, the JAX tests' own):
the closed form per chunk and the sequential recurrences round
differently, most where the cumulative decay is large. ``decay_mu = 1.5``
draws decays of e^-4 to e^-100 a step, which expose a one-token shift of
the carry at once. At those decays the JAX op runs chunks of 16, as its
own strong-decay tests do: its kernel forms the exclusive sum as cwi - lw,
a difference of two large sums, which at chunks of 32 or 64 drifts past
1e-4 of the sequential oracle (0.0003-0.0008 on these inputs).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels.rwkv6_scan.ops import wkv6_chunked as jax_op  # noqa: E402
from repro.kernels.rwkv6_scan.ref import wkv6_ref as jax_ref  # noqa: E402
from repro.models.rwkv6 import wkv6 as jax_model_scan  # noqa: E402
from repro_torch.kernels.rwkv6_scan import wkv6_chunked, wkv6_ref, wkv6_split_ref  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import CHUNK, split_chunks, split_count  # noqa: E402

SCAN_RTOL = 1e-4


def _inputs(seed, b, t, h, hd, decay_mu, state):
    """r, k, v, lw (B, T, H, hd), u (H, hd), state (B, H, hd, hd) or None,
    as numpy f32; lw = -exp(N(decay_mu, 1))."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    lw = -np.exp(rng.normal(decay_mu, 1.0, (b, t, h, hd))).astype(np.float32)
    return [f(b, t, h, hd), f(b, t, h, hd), f(b, t, h, hd), lw, f(h, hd),
            f(b, h, hd, hd) if state else None]


def _torch(arrs):
    return [None if a is None else torch.from_numpy(a) for a in arrs]


def _jax(arrs):
    return [None if a is None else jnp.asarray(a) for a in arrs]


def _close(a_torch, b):
    a = a_torch.numpy()
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape and a.dtype == np.float32, (a.shape, b.shape, a.dtype)
    np.testing.assert_allclose(a, b, rtol=SCAN_RTOL, atol=SCAN_RTOL)


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("n_split", [1, 2, 4, 8])
def test_split_against_jax_and_oracles(n_split, state):
    """T = 300: ten chunks of 32, the last ragged, over 1 to 8 blocks, with
    strong decays."""
    arrs = _inputs(n_split + 10 * state, 2, 300, 2, 16, 1.5, state)
    y, s = wkv6_split_ref(*_torch(arrs), n_split=n_split)
    for yr, sr in (jax_op(*_jax(arrs), chunk=16, interpret=True), jax_ref(*_jax(arrs))):
        _close(y, yr)
        _close(s, sr)
    r, k, v, lw, u, s0 = _jax(arrs)
    ym, sm = jax_model_scan(r, k, v, jnp.exp(lw), u, s0, chunk=100)
    _close(y, ym)
    _close(s, sm)
    yp, sp = wkv6_ref(*_torch(arrs))
    _close(y, yp)
    _close(s, sp)


@pytest.mark.parametrize("t,n_split", [(1, 1), (1, 4), (33, 8), (64, 2)])
def test_split_short_sequences(t, n_split):
    """One token, and more blocks than chunks (blocks with no chunk carry
    the state through unchanged), at hd = 64."""
    arrs = _inputs(20 + t, 3, t, 2, 64, 0.0, True)
    y, s = wkv6_split_ref(*_torch(arrs), n_split=n_split)
    yr, sr = jax_ref(*_jax(arrs))
    _close(y, yr)
    _close(s, sr)


def test_split_at_rwkv6_width():
    """rwkv6-7b's prefill: T = 512 over the 2 blocks its 64 heads get, hd =
    64, from a given state, two of the heads."""
    arrs = _inputs(30, 1, 512, 2, 64, 0.0, True)
    assert split_count(512, 1, 64) == 2
    y, s = wkv6_split_ref(*_torch(arrs), n_split=2)
    yp, sp = wkv6_ref(*_torch(arrs))
    _close(y, yp)
    _close(s, sp)
    yj, sj = jax_op(*_jax(arrs), chunk=16, interpret=True)
    _close(y, yj)
    _close(s, sj)


def test_split_count_comes_from_shapes():
    """Decode gets 1; rwkv6-7b's prompt of 512 over 64 heads 2; the split
    doubles while each block keeps a chunk and the clusters of the doubled
    count all stay resident on an H100; never more than 8."""
    assert split_count(1, 8, 64) == 1
    assert [split_count(t, 1, 64) for t in (256, 512, 1024)] == [2, 2, 2]
    assert split_count(512, 1, 62) == 4  # 62 clusters of 4 fit
    assert split_count(512, 1, 30) == 8  # as do 30 of 8
    assert split_count(512, 3, 64) == 1  # 192 clusters of 2 would not
    assert split_count(64, 1, 16) == 2
    assert split_count(31, 1, 1) == 1
    assert split_count(10_000, 1, 1) == 8
    for t in (1, 31, 32, 33, 100, 300, 512, 1000):
        for n in (1, 2, 3, 5, 8):
            spans = [split_chunks(t, n, j) for j in range(n)]
            assert spans[0][0] == 0 and spans[-1][1] == -(-t // CHUNK)
            assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
            assert all(hi - lo in (-(-t // CHUNK) // n, -(-t // CHUNK) // n + 1) for lo, hi in spans)


def test_split_final_state_over_the_initial_one():
    """The model's decode writes the final state over the initial one: the
    op's in-place result equals the split algorithm's from an untouched
    copy, and the tensor returned is the cache itself."""
    r, k, v, lw, u, s0 = _torch(_inputs(40, 2, 96, 2, 32, 0.0, True))
    y_want, s_want = wkv6_split_ref(r, k, v, lw, u, s0.clone(), n_split=2)
    cache = s0.clone()
    y, s = wkv6_chunked(r, k, v, lw, u, cache, inplace=True)
    assert s is cache
    _close(y, y_want)
    _close(cache, s_want)
