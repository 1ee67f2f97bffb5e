"""The port's sharded engine against the JAX package's, on the CPU.

1. The store: the port's ``ShardedTieredKV`` and the JAX one driven by the
   same global stream of migrations and segmented lookups, at 1, 2 and 4
   shards: rows, drained planes (slot, tenant, role), migration books,
   per-shard tier maps and the dispatch/sync budget are bit-exact. The
   store-facade contracts of ``tests/test_sharded.py`` (idle shard pays
   nothing, degraded flag and quarantine drain, the restricted plan never
   cut, drain-cadence invariance) hold on the port.
2. The engine: a 1-shard ``ShardedServingEngine`` is bit-exact with the
   port's ``ServingEngine``; at 2 and 4 shards its tokens and merged books
   equal the JAX 1-shard engine's. The reference's N-shard engine spreads
   its parameters over a mesh of N devices; the port keeps them whole on
   its one device, so not only the books (which follow page walks, not
   token values) but the tokens too are those of one shard. One tiered
   launch per non-empty shard a step, and a drain costs one host read per
   dirty shard.
3. The fleet: ``build_fleet(model_shards=2)`` builds sharded replicas
   whose books equal those at 1 shard.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs.workloads import get_profile as jax_profile  # noqa: E402
from repro.data.requests import RequestGenerator as JaxGenerator  # noqa: E402
from repro.models.api import get_model as jax_model  # noqa: E402
from repro.runtime.serving import EngineConfig as JaxEngineConfig  # noqa: E402
from repro.runtime.sharded import ShardedServingEngine as JaxShardedEngine  # noqa: E402
from repro.runtime.sharded import ShardedTieredKV as JaxShardedKV  # noqa: E402

import repro_torch.fleet as port_fleet  # noqa: E402
import repro_torch.runtime.tiered_kv as tiered_kv_mod  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.workloads import get_profile  # noqa: E402
from repro_torch.data.requests import RequestGenerator, interleave  # noqa: E402
from repro_torch.device import HOST_READS  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.parity import params_from_jax  # noqa: E402
from repro_torch.runtime.serving import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.runtime.sharded import ShardedServingEngine, ShardedTieredKV  # noqa: E402

N_PAGES, CAP, SLOTS, ROW = 64, 10, 6, 16
# the books a split store counts per shard, not per logical lookup
BUDGET_KEYS = ("lookups", "dispatches", "host_syncs", "drains", "dispatches_per_step",
               "host_syncs_per_step", "shards", "shard_near_capacity", "shard_dispatches",
               "shard_near_hits", "shard_far_hits")

# ---------------------------------------------------------------------------
# 1. the store


def _stores(n_shards: int):
    """The port's and the reference's store, holding the same rows."""
    rows = np.random.default_rng(0).integers(-127, 128, size=(N_PAGES, ROW)).astype(np.float32)
    port = ShardedTieredKV(N_PAGES, ROW, CAP, n_shards, identity_scales=True, counter_slots=SLOTS,
                           device="cpu")
    ref = JaxShardedKV(N_PAGES, ROW, CAP, n_shards, identity_scales=True, counter_slots=SLOTS)
    port.write(np.arange(N_PAGES), torch.as_tensor(rows))
    ref.write(np.arange(N_PAGES), jnp.asarray(rows))
    return port, ref


def _round(store, rng):
    """One round of the mixed stream: a migration, then a ragged segmented
    lookup with slot/tenant/role routing. Returns (migration books, rows)."""
    near = rng.choice(N_PAGES, size=rng.integers(0, CAP + 1), replace=False)
    moved = store.migrate(near)
    sizes = rng.integers(1, 9, size=rng.integers(1, SLOTS + 1))
    ids = rng.integers(0, N_PAGES, size=sizes.sum())
    seg_of = np.repeat(np.arange(sizes.size), sizes).astype(np.int32)
    rows = store.lookup_segments(
        ids, seg_of, SLOTS + 1, slot_idx=list(range(sizes.size)),
        tenant_idx=list(rng.integers(0, 3, size=sizes.size)),
        role_idx=list(rng.integers(0, 2, size=sizes.size)),
    )
    return moved, np.asarray(rows)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sharded_store_matches_reference(n_shards):
    port, ref = _stores(n_shards)
    rng_p, rng_r = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(6):
        mp, rp = _round(port, rng_p)
        mr, rr = _round(ref, rng_r)
        assert mp == mr
        np.testing.assert_array_equal(rp, rr)
        for sp, sr in zip(port.shards, ref.shards):
            np.testing.assert_array_equal(sp.tier_host, sr.tier_host)
            np.testing.assert_array_equal(sp.slot_host, sr.slot_host)
    dp, dr = port.drain_counters(), ref.drain_counters()
    assert (dp["near"], dp["far"]) == (dr["near"], dr["far"]) and dp["near"] + dp["far"] > 0
    for plane in ("slot", "tenant", "role"):
        np.testing.assert_array_equal(dp[plane], dr[plane])
    assert port.take_shard_drains() == ref.take_shard_drains()
    assert port.stats() == ref.stats()
    st = port.stats()
    assert st["shards"] == n_shards and sum(st["shard_near_hits"]) == st["near_hits"]
    # every dirty shard drained once, each a host sync
    assert st["host_syncs"] == st["drains"] <= n_shards
    for ids in (np.arange(0, N_PAGES, 3), np.array([5, 5, 63, 0])):
        rows_p, n_p, f_p = port.lookup(ids)
        rows_r, n_r, f_r = ref.lookup(ids)
        np.testing.assert_array_equal(rows_p.numpy(), np.asarray(rows_r))
        assert (n_p, f_p) == (n_r, f_r)
        np.testing.assert_array_equal(port.lookup_flat(ids).numpy(), np.asarray(ref.lookup_flat(ids)))
        assert port.max_abs_error(ids) == ref.max_abs_error(ids) == 0.0
    assert port.stats() == ref.stats()


def test_sharded_store_rejects_non_divisor():
    with pytest.raises(ValueError, match="divide"):
        ShardedTieredKV(10, 8, 4, 3, device="cpu")


def test_idle_shard_launches_nothing_and_drains_without_a_read():
    store = ShardedTieredKV(16, 8, 6, 2, identity_scales=True, counter_slots=2, device="cpu")
    store.write(np.arange(16), torch.zeros((16, 8)))
    even = np.arange(0, 16, 2)  # all owned by shard 0
    store.lookup_segments(even, np.zeros(even.size, np.int32), 2, slot_idx=[0], tenant_idx=[0],
                          role_idx=[0])
    assert store.stats()["shard_dispatches"] == [1, 0]
    reads = HOST_READS["copies"]
    store.drain_counters()
    assert HOST_READS["copies"] - reads == 1
    assert [sh.host_syncs for sh in store.shards] == [1, 0]
    reads = HOST_READS["copies"]
    store.drain_counters()  # both clean now
    assert HOST_READS["copies"] == reads


@pytest.mark.parametrize("n_shards", [2, 4])
def test_restricted_plan_never_cut(n_shards):
    """A global near set sanitized against the global capacity, restricted
    to a shard, fits that shard's capacity: the shards' tier maps together
    are the unsharded store's."""
    port, _ = _stores(n_shards)
    one, _ = _stores(1)
    rng = np.random.default_rng(11)
    for _ in range(10):
        near = rng.choice(N_PAGES, size=rng.integers(0, CAP + 4), replace=False)
        assert port.migrate(near) == one.migrate(near)
        tier = np.concatenate([np.flatnonzero(sh.tier_host == 0) * n_shards + s
                               for s, sh in enumerate(port.shards)])
        np.testing.assert_array_equal(np.sort(tier), np.flatnonzero(one.shards[0].tier_host == 0))
        assert port.near_count == one.near_count == min(near.size, CAP)


def test_degraded_flag_and_quarantine_drain_match_reference():
    port, ref = _stores(2)
    for s in (port, ref):
        s.migrate(np.arange(8))
        s.set_degraded(True)
        assert s.degraded and all(sh.degraded for sh in s.shards)
        s.migrate(np.arange(16))  # a promote plan while degraded demotes everything
        assert s.near_count == 0
        s.lookup_segments(np.arange(12), np.zeros(12, np.int32), 2, slot_idx=[0], tenant_idx=[0])
    before = (port.near_hits, port.far_hits, port.drains)
    qp, qr = port.drain_counters(discard=True), ref.drain_counters(discard=True)
    assert (qp["near"], qp["far"]) == (qr["near"], qr["far"]) == (0, 12)
    assert (port.near_hits, port.far_hits, port.drains) == before  # uncharged
    assert port.take_shard_drains() == ref.take_shard_drains() == [{"near": 0, "far": 0}] * 2
    d = port.drain_counters()
    assert (d["near"], d["far"]) == (0, 0)
    port.set_degraded(False)
    assert not port.degraded
    assert port.stats() == ref.stats()


def test_drain_cadence_invariance():
    """Draining after every lookup or once at the end charges the same
    merged totals and the same per-shard deltas."""
    totals, shards = [], []
    for every in (True, False):
        store, _ = _stores(2)
        rng = np.random.default_rng(3)
        tot = np.zeros(2, np.int64)
        for _ in range(4):
            store.lookup_segments(rng.integers(0, N_PAGES, 12), np.zeros(12, np.int32), 2,
                                  slot_idx=[0], tenant_idx=[0], role_idx=[0])
            if every:
                d = store.drain_counters()
                tot += (d["near"], d["far"])
        d = store.drain_counters()
        totals.append(tot + (d["near"], d["far"]))
        shards.append(store.take_shard_drains())
    np.testing.assert_array_equal(*totals)
    assert shards[0] == shards[1]


# ---------------------------------------------------------------------------
# 2. the engine


def _ekw(**over):
    kw = dict(max_batch=4, max_len=64, n_pages=256, near_frac=0.02, placement_window=4,
              device_tiering=True, tiered_identity_scales=True)
    kw.update(over)
    return kw


def _prof(get):
    return dataclasses.replace(get("Web1"), prompt_mean=24, decode_mean=8, prefix_share=0.5,
                               n_prefixes=2)


def _run(eng, gen, n_requests: int = 6, watch=None):
    for _ in range(n_requests):
        eng.submit(next(gen))
    tokens = []
    while (eng.queue or any(s.active for s in eng.slots)) and eng.engine_steps < 400:
        if watch is not None:
            watch(eng)
        eng.step()
        tokens.append(np.asarray(eng.next_tokens).copy())
    return np.array(tokens)


@pytest.fixture(scope="module")
def reference():
    """The JAX sharded engine at one shard (a mesh of this host's one
    device), and the port's api and model holding its parameters."""
    cfg = jax_config("smollm-360m").reduced()
    api = jax_model(cfg)
    params = api.init(jax.random.PRNGKey(0))
    eng = JaxShardedEngine(api, params, JaxEngineConfig(**_ekw(model_shards=1)), seed=0)
    tokens = _run(eng, JaxGenerator(_prof(jax_profile), vocab_size=cfg.vocab_size, seed=0))
    tapi = get_model(get_config("smollm-360m").reduced())
    model = tapi.init(0, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)), strict=True)
    return {"tokens": tokens, "live": eng.live_counters(), "stats": eng.stats(),
            "role": eng.role_hits.copy(), "ttft": list(eng.ttft_vt_samples),
            "shard_rows": eng.metrics.total("shard_near_hits"), "port": (tapi, model)}


def _unsharded(st: dict) -> dict:
    """``stats()`` without the books a split store counts per shard."""
    return {**st, "device_tiering": {k: v for k, v in st["device_tiering"].items()
                                     if k not in BUDGET_KEYS}}


def _port_run(reference, n_shards: int, **over):
    tapi, model = reference["port"]
    eng = ServingEngine(tapi, model, EngineConfig(**_ekw(model_shards=n_shards, **over)), seed=0,
                        device="cpu")
    gen = RequestGenerator(_prof(get_profile), vocab_size=tapi.cfg.vocab_size, seed=0)
    return eng, gen


def test_one_shard_engine_is_the_unsharded_engine(reference):
    """A 1-shard engine gives the port's ServingEngine's tokens, counters,
    books and budget, and the reference's 1-shard engine's."""
    tapi, model = reference["port"]
    base = ServingEngine(tapi, model, EngineConfig(**_ekw(tiered_verify=True)), seed=0, device="cpu")
    t_base = _run(base, RequestGenerator(_prof(get_profile), vocab_size=tapi.cfg.vocab_size, seed=0))
    one = ShardedServingEngine(tapi, model, EngineConfig(**_ekw(model_shards=1, tiered_verify=True)),
                               seed=0, device="cpu")
    t_one = _run(one, RequestGenerator(_prof(get_profile), vocab_size=tapi.cfg.vocab_size, seed=0))
    np.testing.assert_array_equal(t_base, t_one)
    np.testing.assert_array_equal(t_one, reference["tokens"])
    assert base.live_counters() == one.live_counters() == reference["live"]
    sb, s1 = base.stats(), one.stats()
    dev1 = s1["device_tiering"]
    assert {k: v for k, v in dev1.items() if not k.startswith("shard")} == sb["device_tiering"]
    assert {**s1, "device_tiering": None} == {**sb, "device_tiering": None}
    assert dev1["shards"] == 1 and dev1["max_read_error"] == 0.0
    assert s1 == {**reference["stats"], "device_tiering": {**reference["stats"]["device_tiering"],
                                                           "max_read_error": 0.0}}
    np.testing.assert_array_equal(one.role_hits, reference["role"])


@pytest.mark.parametrize("n_shards", [2, 4])
def test_n_shard_engine_merges_to_one_shard_books(reference, n_shards, monkeypatch):
    """At N shards the merged books are the reference's 1-shard books (and,
    the parameters being whole here, the tokens too); each step launches
    one tiered gather per non-empty shard, and each drain reads back once
    per dirty shard."""
    launches = []
    orig = tiered_kv_mod.tiered_lookup_segments
    monkeypatch.setattr(tiered_kv_mod, "tiered_lookup_segments",
                        lambda *a, **k: (launches.append(1), orig(*a, **k))[1])
    eng, gen = _port_run(reference, n_shards)
    assert isinstance(eng, ShardedServingEngine) and eng.tiered.n_shards == n_shards
    per_step, drain_reads = [], []
    drain = eng.drain_tier_counters

    def counted_drain():
        dirty = sum(sh._plane_dirty for sh in eng.tiered.shards)
        reads = HOST_READS["copies"]
        out = drain()
        drain_reads.append((HOST_READS["copies"] - reads, dirty))
        return out

    eng.drain_tier_counters = counted_drain

    def watch(e):
        per_step.append(len(launches))

    tokens = _run(eng, gen, watch=watch)
    per_step = np.diff(per_step + [len(launches)])
    np.testing.assert_array_equal(tokens, reference["tokens"])
    assert eng.live_counters() == reference["live"]
    st = eng.stats()
    assert _unsharded(st) == _unsharded(reference["stats"])
    np.testing.assert_array_equal(eng.role_hits, reference["role"])
    assert eng.ttft_vt_samples == reference["ttft"]
    dev = st["device_tiering"]
    assert dev["shards"] == n_shards and dev["near_hits"] > 0 and dev["far_hits"] > 0
    assert sum(dev["shard_near_hits"]) == dev["near_hits"]
    assert sum(dev["shard_far_hits"]) == dev["far_hits"]
    assert eng.metrics.total("shard_near_hits") == dev["near_hits"] == reference["shard_rows"]
    assert eng.metrics.total("shard_far_hits") == dev["far_hits"]
    # the budget: 1..N launches a step, all shards busy in some step
    assert ((per_step >= 1) & (per_step <= n_shards)).all() and per_step.max() == n_shards
    assert eng.tiered.dispatches == len(launches) == sum(dev["shard_dispatches"])
    assert drain_reads and all(r == d for r, d in drain_reads), drain_reads
    assert dev["host_syncs"] == dev["drains"]


def test_engine_builds_sharded_only_for_a_divisor(reference):
    tapi, model = reference["port"]
    for n in (3, 5):
        with pytest.raises(ValueError, match="divide"):
            ServingEngine(tapi, model, EngineConfig(**_ekw(model_shards=n)), device="cpu")
    assert type(ServingEngine(tapi, model, EngineConfig(**_ekw()), device="cpu")) is ServingEngine
    eng = ServingEngine(tapi, model, EngineConfig(**_ekw(model_shards=8)), device="cpu")
    assert isinstance(eng, ShardedServingEngine)
    assert eng.stats()["device_tiering"]["shard_near_capacity"] == [5] * 8  # 5 near pages of 256


def test_chunked_sharded_engine_matches_one_shard(reference):
    """Chunked prefill over a 2-shard store: the 1-shard run's tokens and
    merged books, the prefill role plane included."""
    runs = []
    for n in (1, 2):
        eng, gen = _port_run(reference, n, prefill_chunk=8)
        runs.append((_run(eng, gen), eng.live_counters(), _unsharded(eng.stats()), eng.role_hits))
    (t1, l1, s1, r1), (t2, l2, s2, r2) = runs
    np.testing.assert_array_equal(t1, t2)
    assert l1 == l2 and s1 == s2
    np.testing.assert_array_equal(r1, r2)
    assert s2["device_tiering"]["prefill_near_hits"] + s2["device_tiering"]["prefill_far_hits"] > 0


# ---------------------------------------------------------------------------
# 3. the fleet


def _fleet_books(n_shards: int) -> dict:
    fleet = port_fleet.build_fleet(
        3, policy="least-loaded", autotier=dict(near_frac=0.30, epoch_steps=8), seed=0,
        device="cpu", device_tiering=True, model_shards=n_shards,
    )
    gens = [RequestGenerator(dataclasses.replace(get_profile(base), prompt_mean=24, decode_mean=8,
                                                 prefix_share=0.9, n_prefixes=3),
                             vocab_size=port_fleet.fleet_vocab(), seed=i, rate=8.0, tenant=t)
            for i, (t, base) in enumerate((("web", "Web1"), ("cache", "Cache1")))]
    fleet.run(iter(interleave(gens, 16)), n_requests=16, max_steps=400)
    fs = fleet.fleet_stats()
    engines = [r.engine for r in fleet.replicas]
    return {
        "outcome": fleet.outcome_report(),
        "fleet": {k: v for k, v in fs.items() if k != "per_replica"},
        "replicas": [_unsharded(e.stats()) for e in engines],
        "epochs": [(e.vtime, e.near_ids.tolist(), e.shard_near_capacity)
                   for e in fleet.autotierer.history],
        "types": [type(e) for e in engines],
        "shards": [e.stats()["device_tiering"].get("shards") for e in engines],
    }


def test_fleet_of_sharded_replicas_keeps_the_books():
    try:
        one, two = _fleet_books(1), _fleet_books(2)
    finally:
        port_fleet._MODEL_CACHE.pop(("smollm-360m", "cpu"), None)
    assert two["types"] == [ShardedServingEngine] * 3 and one["types"] == [ServingEngine] * 3
    assert two["shards"] == [2] * 3 and one["shards"] == [None] * 3
    assert one["outcome"] == two["outcome"] and one["fleet"] == two["fleet"]
    assert one["replicas"] == two["replicas"]
    assert [e[:2] for e in one["epochs"]] == [e[:2] for e in two["epochs"]]
    # the AutoTierer sees each sharded host's per-shard near ceilings
    assert all(e[2] == {} for e in one["epochs"])
    assert all(set(e[2]) == {0, 1, 2} and all(len(c) == 2 for c in e[2].values())
               for e in two["epochs"])
    assert one["outcome"]["complete"] and sum(one["outcome"]["outcomes"].values()) == 16
