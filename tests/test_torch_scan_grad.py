"""The scans' gradients: ``WKV6Fn`` and ``SSDFn`` against ``jax.vjp`` of the
reference's jnp scans, on the CPU.

The port's forward (the plain sequential version here, the kernel on the
card) writes the state entering each chunk of 32 tokens, and its backward
(``ref.wkv6_vjp``, ``ref.ssd_vjp``) reverses over the chunks and takes
every chunk's local VJP from its closed form at once. The reference
differentiates its ``lax.scan`` (``repro.models.rwkv6.wkv6``,
``repro.models.mamba2.ssd_scan``; ``wkv6`` takes the decay w = exp(lw),
so its gradient is taken through that exp). Same numpy inputs on both
sides, f32.

Cases: T below, at and across the 32-token chunk, a ragged last chunk
(T = 80), a multiple of the reference's own chunk of 128 (T = 256, where
it checkpoints its chunk bodies), zero and given initial states, and
strong decays: lw = -exp(N(2.5, 1)) a channel a token (cumulative sums
past -88 within a chunk, where a closed form that divides by a
cumulative decay overflows f32), dt A down to some -30 a step. Every
cotangent within 1e-4 of its own scale (its largest magnitude): both sides
sum f32 products in other orders (the closed form's exponent differences
against the step-by-step products), some 1e-6 of the scale.

Also: the chunk-entry states of the plain forward against the reference's
sequential scan over each chunk-aligned prefix; the Functions' forward
against the plain op; the models take the Functions only in a training
forward, which never writes a given state.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.models import mamba2 as jax_mamba2  # noqa: E402
from repro.models import rwkv6 as jax_rwkv6  # noqa: E402
from repro_torch.kernels import mamba2_scan, rwkv6_scan  # noqa: E402
from repro_torch.parity import assert_close  # noqa: E402

SCALE_TOL = 1e-4
LENGTHS = [7, 32, 80, 256]
CHUNK = rwkv6_scan.ref.CHUNK


def _wkv6_inputs(t, state, strong, seed=0, b=2, h=2, hd=16):
    rng = np.random.default_rng(seed + t)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    lw = -np.exp(rng.normal(2.5 if strong else -1.0, 1.0, (b, t, h, hd))).astype(np.float32)
    return [f(b, t, h, hd), f(b, t, h, hd), f(b, t, h, hd), lw, f(h, hd),
            f(b, h, hd, hd) if state else None]


def _ssd_inputs(t, state, strong, seed=0, b=2, h=3, p=16, n=16):
    rng = np.random.default_rng(seed + t)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(1.0 if strong else -1.0, 1.0, (b, t, h)))).astype(np.float32)
    a = -np.exp(rng.normal(2.0 if strong else 0.0, 0.5, h)).astype(np.float32)
    return [f(b, t, h, p), dt, a, f(b, t, n), f(b, t, n), f(h), f(b, h, p, n) if state else None]


def _jax_wkv6(r, k, v, lw, u, s):
    return jax_rwkv6.wkv6(r, k, v, jnp.exp(lw), u, s)


def _check(got, want, names):
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g is not None and g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        assert torch.isfinite(g).all(), name
        scale = float(np.abs(w).max())
        assert_close(g, w, atol=SCALE_TOL * scale + 1e-30, rtol=0, what=name)


def _cotangents(y_shape, s_shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(y_shape).astype(np.float32), rng.standard_normal(s_shape).astype(np.float32)


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("t", LENGTHS)
def test_wkv6_fn_matches_the_reference_vjp(t, state, strong):
    ins = _wkv6_inputs(t, state, strong)
    given = [x for x in ins if x is not None]
    jfn = (lambda *a: _jax_wkv6(*a)) if state else (lambda *a: _jax_wkv6(*a, None))
    (jy, js), vjp = jax.vjp(jfn, *map(jnp.asarray, given))
    dy, ds = _cotangents(jy.shape, js.shape, 1)
    want = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    tin = [torch.from_numpy(x).requires_grad_(True) for x in given]
    y, s = rwkv6_scan.wkv6_train(*tin, *([] if state else [None]))
    assert type(y.grad_fn).__name__ == "WKV6FnBackward"
    assert_close(y, jy, atol=1e-5 * float(np.abs(jy).max()), rtol=0, what="y")
    assert_close(s, js, atol=1e-5 * float(np.abs(js).max()), rtol=0, what="final state")
    got = torch.autograd.grad((y, s), tin, (torch.from_numpy(dy), torch.from_numpy(ds)))
    _check(got, want, ["dr", "dk", "dv", "dlw", "du", "dstate0"])


@pytest.mark.parametrize("strong", [False, True])
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("t", LENGTHS)
def test_ssd_fn_matches_the_reference_vjp(t, state, strong):
    ins = _ssd_inputs(t, state, strong)
    given = [x for x in ins if x is not None]
    jfn = (lambda *a: jax_mamba2.ssd_scan(*a)) if state else (lambda *a: jax_mamba2.ssd_scan(*a, None))
    (jy, js), vjp = jax.vjp(jfn, *map(jnp.asarray, given))
    dy, ds = _cotangents(jy.shape, js.shape, 2)
    want = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    tin = [torch.from_numpy(x).requires_grad_(True) for x in given]
    y, s = mamba2_scan.ssd_train(*tin, *([] if state else [None]))
    assert type(y.grad_fn).__name__ == "SSDFnBackward"
    assert_close(y, jy, atol=1e-5 * float(np.abs(jy).max()), rtol=0, what="y")
    assert_close(s, js, atol=1e-5 * float(np.abs(js).max()), rtol=0, what="final state")
    got = torch.autograd.grad((y, s), tin, (torch.from_numpy(dy), torch.from_numpy(ds)))
    _check(got, want, ["dx", "ddt", "dA", "dB", "dC", "dD", "dstate0"])


@pytest.mark.parametrize("t", [32, 80])
def test_unread_final_state_gets_a_zero_cotangent(t):
    """A model reads y only: the final state's cotangent is zero, and the
    gradients equal the reference's VJP with ds = 0."""
    ins = _wkv6_inputs(t, False, False, seed=5)[:5]
    (jy, _), vjp = jax.vjp(lambda *a: _jax_wkv6(*a, None), *map(jnp.asarray, ins))
    dy, _ = _cotangents(jy.shape, (1,), 3)
    want = vjp((jnp.asarray(dy), jnp.zeros((2, 2, 16, 16), jnp.float32)))
    tin = [torch.from_numpy(x).requires_grad_(True) for x in ins]
    y, _ = rwkv6_scan.wkv6_train(*tin)
    _check(torch.autograd.grad(y, tin, torch.from_numpy(dy)), want, ["dr", "dk", "dv", "dlw", "du"])


@pytest.mark.parametrize("t", [7, 32, 80])
def test_wkv6_chunk_states_are_the_reference_scans(t):
    """The plain forward's chunk-entry states (B, H, C, hd, hd), C =
    ceil(T / 32): each the reference's sequential scan over the tokens
    before that chunk, from the given state."""
    r, k, v, lw, u, s0 = _wkv6_inputs(t, True, True, seed=7)
    y, s, states = rwkv6_scan.wkv6_chunked(*(torch.from_numpy(x) for x in (r, k, v, lw, u, s0)),
                                           return_states=True)
    assert tuple(states.shape) == (2, 2, -(-t // CHUNK), 16, 16)
    for c in range(states.shape[2]):
        t0 = c * CHUNK
        want = s0 if t0 == 0 else jax_rwkv6._wkv6_seq(jnp.asarray(s0), *(jnp.asarray(x[:, :t0]) for x in (
            r, k, v, np.exp(lw))), jnp.asarray(u))[0]
        assert_close(states[:, :, c], want, atol=1e-5 * float(np.abs(want).max()), rtol=0, what=f"chunk {c}")
    assert_close(y, rwkv6_scan.wkv6_ref(*(torch.from_numpy(x) for x in (r, k, v, lw, u, s0)))[0], atol=0,
                 rtol=0, what="y")


@pytest.mark.parametrize("t", [7, 32, 80])
def test_ssd_chunk_states_are_the_reference_scans(t):
    x, dt, a, bm, cm, d, s0 = _ssd_inputs(t, True, True, seed=8)
    y, s, states = mamba2_scan.ssd_chunked(*(torch.from_numpy(z) for z in (x, dt, a, bm, cm, d, s0)),
                                           return_states=True)
    assert tuple(states.shape) == (2, 3, -(-t // CHUNK), 16, 16)
    for c in range(states.shape[2]):
        t0 = c * CHUNK
        want = s0 if t0 == 0 else jax_mamba2._ssd_seq(
            jnp.asarray(s0), jnp.asarray(x[:, :t0]), jnp.asarray(dt[:, :t0]), jnp.asarray(a),
            jnp.asarray(bm[:, :t0]), jnp.asarray(cm[:, :t0]))[0]
        assert_close(states[:, :, c], want, atol=1e-5 * float(np.abs(want).max()), rtol=0, what=f"chunk {c}")


def test_strong_decays_overflow_no_closed_form():
    """lw summing past -88 within one chunk: exp(-cumsum) would be inf in
    f32. The VJP's closed form keeps every exponent <= 0, so its gradients
    are finite and match autograd through the sequential plain version."""
    r, k, v, lw, u, _ = _wkv6_inputs(64, False, True, seed=9)
    lw = lw - 5.0  # some -6 to -60 a token
    assert float(np.cumsum(lw, axis=1)[:, 31].min()) < -88
    ins = [torch.from_numpy(z) for z in (r, k, v, lw, u)]
    want_in = [z.clone().requires_grad_(True) for z in ins]
    y, _ = rwkv6_scan.wkv6_ref(*want_in)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(0))
    want = torch.autograd.grad(y, want_in, dy)
    got_in = [z.clone().requires_grad_(True) for z in ins]
    got = torch.autograd.grad(rwkv6_scan.wkv6_train(*got_in)[0], got_in, dy)
    _check(got, [w.numpy() for w in want], ["dr", "dk", "dv", "dlw", "du"])


def test_models_take_the_functions_only_in_a_training_forward():
    """rwkv6's time-mix and the Mamba2 block reach WKV6Fn and SSDFn when
    their leaves require grad under grad mode, and the plain ops otherwise;
    a training forward leaves a given wkv state untouched and refuses a
    Mamba2 cache state (it would be written in place)."""
    from repro_torch.configs import get_config
    from repro_torch.models import mamba2, rwkv6
    from repro_torch.models.api import get_model

    cfg = get_config("rwkv6-7b").reduced()
    model = get_model(cfg).init(0, device="cpu")
    layer = model.layers[0]
    x = torch.randn(2, 12, cfg.d_model)
    z = torch.zeros(2, cfg.d_model)
    s0 = torch.randn(2, cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim, cfg.ssm_head_dim)
    keep = s0.clone()
    with torch.no_grad():
        plain = rwkv6._time_mix(layer.tree()["att"], cfg, x, z, s0.clone(), inplace=False)
    for p in layer.parameters():
        p.requires_grad_(True)
    try:
        out, _, s = rwkv6._time_mix(layer.tree()["att"], cfg, x, z, s0, inplace=True)
        assert out.grad_fn is not None and torch.equal(s0, keep)
        assert_close(out, plain[0], atol=1e-6, rtol=1e-6, what="time-mix under grad")
        assert_close(s, plain[2], atol=1e-6, rtol=1e-6, what="state under grad")
    finally:
        for p in layer.parameters():
            p.requires_grad_(False)
    zcfg = get_config("zamba2-1.2b").reduced()
    zmodel = get_model(zcfg).init(0, device="cpu")
    blk = zmodel.layers[0]
    x = torch.randn(2, 12, zcfg.d_model)
    with torch.no_grad():
        want, _ = mamba2.apply(blk.tree(), zcfg, x)
    for p in blk.parameters():
        p.requires_grad_(True)
    try:
        got, st = mamba2.apply(blk.tree(), zcfg, x)
        assert type(st["ssm"].grad_fn).__name__ == "SSDFnBackward"
        assert torch.equal(got.detach(), want)
        with pytest.raises(ValueError, match="no cache state"):
            mamba2.apply(blk.tree(), zcfg, x, mamba2.init_state(zcfg, 2))
    finally:
        for p in blk.parameters():
            p.requires_grad_(False)
