"""The frozen copies are the program's arithmetic as it stands, and the
traffic gives every seed the same work in another order."""
import numpy as np
import pytest

from bench.frozen import requests as frozen_requests
from bench.frozen import work as frozen_work
from bench.harness.traffic import Traffic, fit
from repro_torch.configs.workloads import PROFILES
from repro_torch.data.requests import RequestGenerator
from repro_torch.kernels import work


@pytest.mark.parametrize("name", ["Web1", "Reader", "Cache1"])
@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_frozen_generator_yields_the_programs_requests(name, seed):
    p = PROFILES[name]
    prof = frozen_requests.Profile(p.name, p.zipf_alpha, p.prefix_share, p.n_prefixes, p.prompt_mean,
                                   p.decode_mean)
    ours = frozen_requests.RequestGenerator(prof, 32000, seed=seed, rate=3.0)
    theirs = RequestGenerator(p, vocab_size=32000, seed=seed, rate=3.0)
    for _ in range(60):
        a, b = next(ours), next(theirs)
        assert (a.rid, a.decode_len, a.prefix_id, a.arrival) == (b.rid, b.decode_len, b.prefix_id, b.arrival)
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_frozen_work_is_the_programs():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 64, 40)
    tier = rng.integers(0, 2, 64).astype(np.int32)
    cases = [
        ("tiered_lookup", (40, 256, 4, 5), {}),
        ("tiered_lookup", (64, 32768, 4, 33), {"ids": np.concatenate([ids, np.zeros(24, np.int64)]), "tier": tier}),
        ("gather_rows", (40, 128, 1, True), {"ids": ids}),
        ("flash_attention", (1, 24, 8, 512, 512, 64, 2, True), {}),
        ("flash_attention", (2, 32, 32, 300, 1200, 64, 4, False), {"return_lse": True}),
        ("flash_attention", (2, 8, 8, 100, 700, 64, 2, True), {"q_offset": 600, "lk_valid": 650}),
        ("paged_attention", (32, 24, 8, 64, 2, 2, 64, 16), {"lengths": list(rng.integers(1, 1025, 32))}),
        ("paged_attention", (32, 32, 32, 64, 4, 2, 128, 16), {}),
        ("wkv6", (1, 512, 64, 64, False), {}),
        ("ssd", (1, 777, 64, 64, 64, False), {}),
        ("ssd", (32, 1, 64, 64, 64, True), {"return_states": True}),
    ]
    for name, args, kw in cases:
        assert getattr(frozen_work, name)(*args, **kw) == getattr(work, name)(*args, **kw), name


def test_lookup_bucket_is_the_stores():
    from repro_torch.runtime.tiered_kv import _bucket

    for n in (1, 31, 32, 33, 1000, 1024, 1025):
        assert frozen_work.lookup_bucket(n) == _bucket(n)


def _mix(kind="closed"):
    return {"profile": {"name": "Web1", "zipf_alpha": 1.25, "prefix_share": 0.85, "n_prefixes": 32,
                        "prompt_mean": 512, "decode_mean": 64},
            "loop": {"kind": kind, "clients": 32, "rate": 5.0},
            "engine": {"max_len": 1024}, "shapes": {"seed": 0, "block": 16}}


def test_traffic_is_the_same_work_with_other_tokens():
    a = Traffic(_mix("open"), 49155, seed=11)
    b = Traffic(_mix("open"), 49155, seed=2**31 + 11)
    a2 = Traffic(_mix("open"), 49155, seed=11)
    ia, ib, ia2 = ([t.next() for _ in range(40)] for t in (a, b, a2))
    for x, y in zip(ia, ia2):  # one seed, one input
        np.testing.assert_array_equal(x.tokens, y.tokens)
    for x, y in zip(ia, ib):  # every seed: the same shapes at the same times, other tokens
        assert (len(x.tokens), x.decode_len, x.prefix_id, x.gap) == (len(y.tokens), y.decode_len, y.prefix_id, y.gap)
    assert not all(np.array_equal(x.tokens, y.tokens) for x, y in zip(ia, ib))
    assert [x.decode_len for x in ia[16:32]] == [x.decode_len for x in ia[:16]]  # the block again
    assert np.mean(a.gaps) == pytest.approx(1 / 5.0)
    for x in ia:
        assert len(x.tokens) <= 1022 and len(x.tokens) + x.decode_len + 1 <= 1024
        if x.prefix_id >= 0:
            np.testing.assert_array_equal(x.tokens[:384], a.templates[x.prefix_id])


def test_fit_is_the_engines_bound():
    t, d = fit(np.arange(2000), 500, 1024)
    assert len(t) == 1022 and d == 1
    t, d = fit(np.arange(100), 50, 1024)
    assert len(t) == 100 and d == 50
