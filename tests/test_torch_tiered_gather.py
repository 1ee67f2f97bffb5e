"""The tiered-gather ops of the port (plain PyTorch versions on the CPU) against
the JAX package's ops (Pallas kernels in interpret mode), bit-exact: rows
and near/far counters, for f32 and bf16 near stores, empty, duplicate and
out-of-range ids (wrapped and clamped as JAX indexes), and all-near /
all-far tier maps."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels.tiered_gather import ops as jax_ops  # noqa: E402
from repro_torch.kernels.tiered_gather import ops  # noqa: E402

N_PAGES, D, N_SEG = 40, 24, 5  # D is not a lane multiple: the JAX op pads it


def _case(seed: int, kind: str):
    """Numpy inputs of one store and one ragged lookup."""
    rng = np.random.default_rng(seed)
    cap = N_PAGES if kind == "all_near" else 12
    tier = np.ones(N_PAGES, np.int32)
    slot = np.arange(N_PAGES, dtype=np.int32)
    if kind != "all_far":
        near = rng.choice(N_PAGES, cap, replace=False)
        tier[near] = 0
        slot[near] = rng.permutation(cap)
    n = 0 if kind == "empty" else 37
    ids = rng.integers(-2, N_PAGES + 2, n) if kind == "out_of_range" else rng.integers(0, N_PAGES, n)
    if kind == "dup":
        ids = rng.choice(ids[:4], n)
    return {
        "hot": rng.standard_normal((cap, D)).astype(np.float32),
        "cold_q": rng.integers(-127, 128, (N_PAGES, D)).astype(np.int8),
        "cold_scales": rng.uniform(1e-3, 1e-1, N_PAGES).astype(np.float32),
        "tier": tier,
        "slot": slot,
        "ids": ids.astype(np.int32),
        "seg_of": np.sort(rng.integers(0, N_SEG - 1, n)).astype(np.int32),
    }


def _both(c, near_dtype):
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[near_dtype]
    j = {k: jnp.asarray(v) for k, v in c.items()}
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    j["hot"], t["hot"] = j["hot"].astype(jdt), t["hot"].to(tdt)
    return j, t


def _eq(a_torch, b_jax):
    a, b = a_torch.numpy(), np.asarray(b_jax)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["mixed", "dup", "empty", "all_near", "all_far", "out_of_range"])
@pytest.mark.parametrize("near_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_tiered_ops_bit_exact_against_jax(seed, near_dtype, kind):
    j, t = _both(_case(seed, kind), near_dtype)
    store = ("hot", "cold_q", "cold_scales", "tier", "slot", "ids")
    before = dict(ops.LAUNCHES)
    rows_t, hits_t = ops.tiered_lookup_segments(*(t[k] for k in store), t["seg_of"], N_SEG)
    rows_j, hits_j = jax_ops.tiered_lookup_segments(*(j[k] for k in store), j["seg_of"], N_SEG)
    _eq(rows_t, rows_j)
    _eq(hits_t, hits_j)
    rows_t, near_t, far_t = ops.tiered_lookup_counted(*(t[k] for k in store))
    rows_j, near_j, far_j = jax_ops.tiered_lookup_counted(*(j[k] for k in store))
    _eq(rows_t, rows_j)
    assert (int(near_t), int(far_t)) == (int(near_j), int(far_j))
    n = len(t["ids"])
    assert int(hits_t.sum()) == n and int(near_t) + int(far_t) == n
    if kind == "all_near":
        assert int(far_t) == 0
    if kind == "all_far":
        assert int(near_t) == 0
    # CPU tensors take the plain versions: no kernel launch is counted
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("src_dtype", ["f32", "int8"])
def test_gather_rows_bit_exact_against_jax(src_dtype, scaled):
    c = _case(3, "dup")
    src = c["hot"] if src_dtype == "f32" else c["cold_q"][: c["hot"].shape[0]]
    scales = c["cold_scales"][: src.shape[0]] if scaled else None
    ids = c["ids"] % src.shape[0]
    out_t = ops.gather_rows(torch.from_numpy(src), torch.from_numpy(ids),
                            None if scales is None else torch.from_numpy(scales))
    out_j = jax_ops.gather_rows(jnp.asarray(src), jnp.asarray(ids),
                                None if scales is None else jnp.asarray(scales))
    _eq(out_t, out_j)


def test_wrappers_refuse_what_the_kernel_does_not_take():
    c = {k: torch.from_numpy(v) for k, v in _case(0, "mixed").items()}
    store = [c[k] for k in ("hot", "cold_q", "cold_scales", "tier", "slot", "ids")]
    with pytest.raises(ValueError, match="ids"):
        ops.tiered_lookup_counted(*store[:5], c["ids"].long())
    with pytest.raises(ValueError, match="hot"):
        ops.tiered_lookup_counted(c["hot"].double(), *store[1:])
    with pytest.raises(ValueError, match="int8"):
        ops.tiered_lookup_segments(store[0], c["cold_q"].int(), *store[2:], c["seg_of"], N_SEG)
    with pytest.raises(ValueError, match="tier"):
        ops.tiered_lookup_counted(*store[:3], c["tier"].long(), *store[4:])
