"""The SSD prefill kernel's algorithm in plain PyTorch (``ssd_split_ref``:
each sequence split over n_split blocks of whole chunks, each block's local
state and decay folded in block order) against the JAX package's op (the
Pallas kernel in interpret mode), its oracle and the model's own scan
(``repro.models.mamba2.ssd_scan``), on the same inputs made with numpy
from a seed; and the split rule ``split_count``.

Tolerance: 1e-4 in f32 (``SCAN_RTOL`` of the smoke, the JAX tests' own):
the closed form per chunk and the sequential recurrences round
differently, most where the cumulative decay is large. Decays reach
|dt A| of about 10 a step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels.mamba2_scan.ops import ssd_chunked as jax_op  # noqa: E402
from repro.kernels.mamba2_scan.ref import ssd_ref as jax_ref  # noqa: E402
from repro.models.mamba2 import ssd_scan as jax_model_scan  # noqa: E402
from repro_torch.kernels.mamba2_scan import ssd_chunked, ssd_ref, ssd_split_ref  # noqa: E402
from repro_torch.kernels.mamba2_scan.ref import CHUNK, split_chunks, split_count  # noqa: E402

SCAN_RTOL = 1e-4


def _inputs(seed, b, t, h, p, n, state):
    """x (b, T, H, P), dt = softplus(N(0, 1.5)), A = -exp(U(-2, 1)) (so
    |dt A| up to about 10), B, C (b, T, N), D (H,), state or None."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(0.0, 1.5, (b, t, h)))).astype(np.float32)
    a = -np.exp(rng.uniform(-2.0, 1.0, h)).astype(np.float32)
    return [f(b, t, h, p), dt, a, f(b, t, n), f(b, t, n), f(h), f(b, h, p, n) if state else None]


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
    """T = 300: ten chunks of 32, the last ragged, over 1 to 8 blocks."""
    arrs = _inputs(n_split + 10 * state, 2, 300, 2, 16, 32, state)
    y, s = ssd_split_ref(*_torch(arrs), n_split=n_split)
    for yr, sr in (jax_op(*_jax(arrs), chunk=64, interpret=True), jax_ref(*_jax(arrs))):
        _close(y, yr)
        _close(s, sr)
    x, dt, a, bm, cm, d, s0 = _jax(arrs)
    s0 = jnp.zeros((2, 2, 16, 32), jnp.float32) if s0 is None else s0
    ym, sm = jax_model_scan(x, dt, a, bm, cm, d, s0, chunk=100)
    _close(y, ym)
    _close(s, sm)
    yp, sp = ssd_ref(*_torch(arrs))
    _close(y, yp)
    _close(s, sp)


@pytest.mark.parametrize("t,n_split", [(1, 1), (1, 4), (33, 8), (64, 2)])
def test_split_short_sequences(t, n_split):
    """One step, and more blocks than chunks (blocks with no chunk carry
    the state through unchanged), at P = 64, N = 16."""
    arrs = _inputs(20 + t, 3, t, 2, 64, 16, True)
    y, s = ssd_split_ref(*_torch(arrs), n_split=n_split)
    yr, sr = jax_ref(*_jax(arrs))
    _close(y, yr)
    _close(s, sr)


def test_split_at_zamba2_width():
    """zamba2-1.2b's prefill: T = 512 over the 2 blocks its 64 heads get,
    P = N = 64, from a given state, four of the heads."""
    arrs = _inputs(30, 1, 512, 4, 64, 64, True)
    assert split_count(512, 1, 64) == 2
    y, s = ssd_split_ref(*_torch(arrs), n_split=2)
    yp, sp = ssd_ref(*_torch(arrs))
    _close(y, yp)
    _close(s, sp)
    yj, sj = jax_op(*_jax(arrs), chunk=64, interpret=True)
    _close(y, yj)
    _close(s, sj)


def test_split_count_comes_from_shapes():
    """Decode gets 1; zamba2's prompt of 512 over 64 heads 2; the split
    doubles while each block keeps a chunk and the clusters of the doubled
    count all stay resident on an H100; never more than 8."""
    assert split_count(1, 8, 64) == 1
    assert [split_count(t, 1, 64) for t in (256, 512, 1024)] == [2, 2, 2]
    assert split_count(512, 1, 62) == 4  # 62 clusters of 4 fit
    assert split_count(512, 1, 30) == 8  # as do 30 of 8
    assert split_count(512, 3, 64) == 1  # 192 clusters of 2 would not
    assert split_count(64, 1, 16) == 2  # two chunks
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
    x, dt, a, bm, cm, d, s0 = _torch(_inputs(40, 2, 96, 2, 32, 16, True))
    y_want, s_want = ssd_split_ref(x, dt, a, bm, cm, d, s0.clone(), n_split=2)
    cache = s0.clone()
    y, s = ssd_chunked(x, dt, a, bm, cm, d, cache, inplace=True)
    assert s is cache
    _close(y, y_want)
    _close(cache, s_want)
