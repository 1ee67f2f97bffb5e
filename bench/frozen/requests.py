"""A frozen copy of ``repro_torch.data.requests.RequestGenerator`` (its
``__init__`` and ``__next__``): seeded serving requests for one workload
profile. ``bench/tests/test_bench_frozen.py`` holds it to the program's
generator request for request."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Profile:
    """The profile fields the generator reads (``configs/workloads.py``)."""

    name: str
    zipf_alpha: float
    prefix_share: float
    n_prefixes: int
    prompt_mean: int
    decode_mean: int


@dataclasses.dataclass
class Shape:
    """One generated request: prompt ids, answer length, shared template
    (-1: none) and arrival on the generator's clock (seconds at ``rate``)."""

    rid: int
    tokens: np.ndarray
    decode_len: int
    prefix_id: int
    arrival: float


def prefix_len(profile: Profile) -> int:
    """Length of each shared template."""
    return max(8, int(profile.prompt_mean * 0.75))


class RequestGenerator:
    def __init__(self, profile: Profile, vocab_size: int, seed: int = 0, rate: float = 8.0):
        self.p = profile
        self.vocab = vocab_size
        self.rng = np.random.default_rng(seed)
        self.rate = rate
        self._prefixes = [
            self.rng.integers(0, vocab_size, size=prefix_len(profile)).astype(np.int32)
            for _ in range(profile.n_prefixes)
        ]
        ranks = np.arange(1, profile.n_prefixes + 1, dtype=np.float64)
        pz = ranks ** -max(profile.zipf_alpha, 0.5)
        self._prefix_probs = pz / pz.sum()
        self._next_id = 0
        self._clock = 0.0

    def __iter__(self):
        return self

    def __next__(self) -> Shape:
        p = self.p
        self._clock += float(self.rng.exponential(1.0 / self.rate))
        rid = self._next_id
        self._next_id += 1
        if self.rng.random() < p.prefix_share:
            pid = int(self.rng.choice(p.n_prefixes, p=self._prefix_probs))
            suffix_len = max(1, int(self.rng.exponential(p.prompt_mean * 0.25)))
            suffix = self.rng.integers(0, self.vocab, size=suffix_len).astype(np.int32)
            tokens = np.concatenate([self._prefixes[pid], suffix])
        else:
            pid = -1
            n = max(4, int(self.rng.exponential(p.prompt_mean)))
            tokens = self.rng.integers(0, self.vocab, size=n).astype(np.int32)
        decode_len = max(1, int(self.rng.exponential(p.decode_mean)))
        return Shape(rid, tokens, decode_len, pid, self._clock)
