"""One seeded sequence of store operations on the JAX TieredKVCache and the
port's: writes of the same rows, migrations (duplicate and out-of-range near
ids, degraded mode), per-call and segmented lookups with slot, tenant and role
routing, and drains (discard included). Maps, free lists, drained planes and
books must be identical, and every row bit-exact, under identity and absmax
scales."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.runtime.tiered_kv import TieredKVCache as JaxStore  # noqa: E402
from repro.runtime.tiered_kv import sanitize_near_ids as jax_sanitize  # noqa: E402
from repro_torch.runtime.tiered_kv import TieredKVCache as TorchStore  # noqa: E402
from repro_torch.runtime.tiered_kv import sanitize_near_ids  # noqa: E402

N_PAGES, D, CAP, N_SEG = 64, 40, 10, 5


def _rows_equal(a_torch, b_jax):
    np.testing.assert_array_equal(a_torch.numpy(), np.asarray(b_jax))


def _books_equal(t, j):
    assert t.stats() == j.stats()
    np.testing.assert_array_equal(t.tier_host, j.tier_host)
    np.testing.assert_array_equal(t.slot_host, j.slot_host)
    assert t._free_near == j._free_near
    _rows_equal(t.near, j.near)
    _rows_equal(t.far_q, j.far_q)
    _rows_equal(t.far_scale, j.far_scale)
    _rows_equal(t.flat, j.flat)


def _drain_equal(dt, dj):
    assert set(dt) == set(dj)
    for k in dt:
        np.testing.assert_array_equal(np.asarray(dt[k]), np.asarray(dj[k]), err_msg=k)


@pytest.mark.parametrize("identity", [True, False])
def test_store_op_sequence_matches_reference(identity):
    rng = np.random.default_rng(0)
    t = TorchStore(N_PAGES, D, CAP, identity_scales=identity, counter_slots=3, device="cpu")
    j = JaxStore(N_PAGES, D, CAP, identity_scales=identity, counter_slots=3)

    def both(name, *args, **kw):
        return getattr(t, name)(*args, **kw), getattr(j, name)(*args, **kw)

    assert both("migrate", rng.choice(N_PAGES, CAP, replace=False), account=False)[0] is not None
    _books_equal(t, j)
    for rnd in range(3):
        # writes: duplicate ids (the last row wins), values spanning the int8 grid
        pids = rng.integers(0, N_PAGES, 30)
        rows = (rng.standard_normal((30, D)) * 40).astype(np.float32)
        both("write", pids, rows)
        _books_equal(t, j)
        # a placement push with duplicates and out-of-range ids
        near = np.concatenate([rng.integers(-3, N_PAGES + 3, CAP + 4), [5, 5, 5]])
        mt, mj = both("migrate", near)
        assert mt == mj
        _books_equal(t, j)
        # per-call lookup: rows and host-read counters
        ids = rng.integers(0, N_PAGES, 17)
        (rt, nt, ft), (rj, nj, fj) = both("lookup", ids)
        _rows_equal(rt, rj)
        assert (nt, ft) == (nj, fj)
        # segmented lookups with slot / tenant / role routing (tenant 4 grows the plane)
        for k in range(2):
            ids = rng.integers(0, N_PAGES, 23 + k)
            seg = np.sort(rng.integers(0, N_SEG - 1, ids.size))
            kw = dict(slot_idx=[2, 0, 1, 2], tenant_idx=[0, 4, 1, 0], role_idx=[0, 1, 0, 1])
            rt, rj = both("lookup_segments", ids, seg, N_SEG, **kw)
            _rows_equal(rt, rj)
        if rnd == 1:
            # degraded mode: every migrate resolves to the empty near set
            both("set_degraded", True)
            mt, mj = both("migrate", near)
            assert mt == mj
            _books_equal(t, j)
            assert t.near_count == 0
            both("set_degraded", False)
        dt, dj = both("drain_counters", discard=(rnd == 2))
        _drain_equal(dt, dj)
        # a drained plane is clean: a second drain returns zeros, charges nothing
        dt, dj = both("drain_counters")
        _drain_equal(dt, dj)
        assert dt["near"] == dt["far"] == 0
        _books_equal(t, j)
        probe = rng.integers(0, N_PAGES, 9)
        _rows_equal(t.lookup_flat(probe), j.lookup_flat(probe))
        assert t.max_abs_error(probe) == j.max_abs_error(probe)
        if identity:
            assert t.max_abs_error(probe) == 0.0
    assert t.stats()["drains"] == 2 and t.stats()["host_syncs"] == 5


def test_sanitize_near_ids_matches_reference():
    rng = np.random.default_rng(7)
    for _ in range(20):
        ids = rng.integers(-5, 70, rng.integers(0, 40))
        np.testing.assert_array_equal(sanitize_near_ids(ids, 64, 12), jax_sanitize(ids, 64, 12))


def test_counter_plane_accumulates_duplicate_indices():
    """Two segments routed to one slot both count (index_add_, not t[idx] += x)."""
    t = TorchStore(8, 4, 2, counter_slots=2, device="cpu")
    t.migrate([0, 1], account=False)
    t.lookup_segments([0, 1, 2, 3], [0, 0, 1, 1], 3, slot_idx=[1, 1], tenant_idx=[0, 0])
    d = t.drain_counters()
    np.testing.assert_array_equal(d["slot"], [[0, 0], [2, 2]])
    np.testing.assert_array_equal(d["tenant"], [[2, 2]])
    assert (d["near"], d["far"]) == (2, 2)
