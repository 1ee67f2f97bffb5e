"""The check at a size a test run holds, on the CPU (the harness's look for
a card skipped): sound runs of the tiny cells come out correct; the float8
control put in the program's place fails their limits; and a run with the
timed path broken underneath comes out not correct, once for each fault a
serving cell on one card can have: a decode that leaves its state
unchanged, half of the batch left out (every other row given the mean of
the rest), and a token altered where it is produced."""
import contextlib

import pytest
import torch

from bench.harness import spec
from bench.harness.cell import execute
from bench.reference.common import Precision
from bench.tests.tiny_cells import TINY, TINY_LIMITS, make_root
from repro_torch.models.api import ModelAPI

CPU = torch.device("cpu")
WINDOW_S = 1.0


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


def _run(root, name, seed, control=None):
    cell = spec.load_cell(name, root)
    return execute(cell, seed, WINDOW_S, False, CPU, lambda: 1.0, control=control)


@pytest.mark.parametrize("name", sorted(TINY))
def test_sound_runs_are_correct_and_the_control_is_not(root, name):
    out = _run(root, name, 2**31 + 11, control=Precision("fp8"))
    assert out["correct"], out["check"]
    assert out["info"]["check_rows"] >= 1 and out["info"]["check_served_tokens"] >= 24
    assert out["info"]["check_requests"] >= 3
    low = out["info"]["control"]  # judged by the same check, it has to fail one of the numbers
    assert not low["correct"], low["numbers"]
    assert "books" not in low["numbers"] and set(low["numbers"]) == set(TINY_LIMITS) - {"books"}


@contextlib.contextmanager
def _broken_decode(fault):
    orig = ModelAPI.decode
    calls = [0]

    def decode(self, params, cache, tokens, *, page_size=16, active=None):
        calls[0] += 1
        if fault == "state_unchanged":
            kept = {k: v.clone() for k, v in cache.items()}
            logits, new = orig(self, params, cache, tokens, page_size=page_size, active=active)
            for k, v in cache.items():
                v.copy_(kept[k])
            return logits, {k: kept[k].clone() if new[k] is not cache[k] else cache[k] for k in cache}
        logits, new = orig(self, params, cache, tokens, page_size=page_size, active=active)
        if fault == "half_batch":  # every other row left out, given the mean of the rest
            logits = logits.clone()
            logits[0::2] = logits[1::2].mean(0, keepdim=True)
        elif fault == "token_altered":  # one row's token a step, the rows in turn
            logits = logits.clone()
            row = calls[0] % logits.shape[0]
            logits[row] = logits[row].roll(1, dims=-1)
        return logits, new

    ModelAPI.decode = decode
    try:
        yield
    finally:
        ModelAPI.decode = orig


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "token_altered"])
@pytest.mark.parametrize("name", sorted(TINY))
def test_a_broken_timed_path_is_not_correct(root, name, fault):
    with _broken_decode(fault):
        out = _run(root, name, 2**31 + 12)
    assert not out["correct"], out["check"]


def test_wrong_books_are_not_correct(root, monkeypatch):
    from repro_torch.runtime import tiered_kv

    orig = tiered_kv.TieredKVCache.drain_counters

    def drain(self, discard=False):
        out = orig(self, discard)
        if not discard:
            self.near_hits += 1  # one hit charged twice
        return out

    monkeypatch.setattr(tiered_kv.TieredKVCache, "drain_counters", drain)
    out = _run(root, "tiny-moe.web1", 2**31 + 13)
    assert not out["correct"] and out["check"]["books"]["value"] > 0
