"""One general generator for every traffic mix: a mix file's parameters in,
the run's requests out.

Every seed serves the same work in the same order, with its own tokens.
The mix's request shapes (prompt length, shared template, answer length,
gap to the next arrival) are a block of ``shapes.block`` drawn from the
frozen generator at the mix's own fixed ``shapes.seed``, sent in that
order and again from its start when a run needs more; the gaps are scaled
so that they average 1 / rate exactly. The run's seed draws every token:
the templates and each request's own ids. So two seeds queue the same
prompt and answer lengths at the same times: in an open loop the order of
arrivals is the queueing itself, and reshuffling it per seed moved the
open-loop reader cell's TTFT p95 by 16% between seeds where two runs of one seed
agreed within 3%.
"""
from __future__ import annotations

import dataclasses
import numpy as np

from bench.frozen.requests import Profile, RequestGenerator, prefix_len


@dataclasses.dataclass
class Item:
    """One request of the run, as the harness sends it."""

    index: int  # order of sending
    tokens: np.ndarray  # the prompt, within the engine's context
    decode_len: int  # tokens the engine decodes after the first
    prefix_id: int
    gap: float  # seconds after the previous arrival (open loop)


def profile(mix: dict) -> Profile:
    return Profile(**mix["profile"])


def fit(tokens: np.ndarray, decode_len: int, max_len: int):
    """The engine's own bound on a request: a prompt of at most ``max_len -
    2`` tokens and an answer that ends inside the context. Applied here so
    that the harness knows exactly what the engine serves."""
    tokens = tokens[: max(1, max_len - 2)]
    return tokens, max(1, min(decode_len, max_len - len(tokens) - 1))


class Traffic:
    """The run's requests, made on demand in sending order."""

    def __init__(self, mix: dict, vocab_size: int, seed: int):
        self.mix = mix
        self.prof = profile(mix)
        self.vocab = vocab_size
        self.max_len = int(mix["engine"]["max_len"])
        sh = mix["shapes"]
        rate = float(mix["loop"].get("rate", 1.0))
        gen = RequestGenerator(self.prof, vocab_size, seed=int(sh["seed"]), rate=rate)
        self.shapes = [next(gen) for _ in range(int(sh["block"]))]
        # the block's gaps, scaled so that their mean is 1 / rate exactly (a
        # block of 64 exponential gaps alone can miss it by a fifth)
        gaps = np.diff(np.array([s.arrival for s in self.shapes]), prepend=0.0)
        self.gaps = gaps / (gaps.mean() * rate)
        self.rng = np.random.default_rng(int(seed))
        plen = prefix_len(self.prof)
        self.templates = [self.rng.integers(0, vocab_size, size=plen).astype(np.int32)
                          for _ in range(self.prof.n_prefixes)]
        self.made = 0

    def next(self) -> Item:
        j = self.made % len(self.shapes)
        s = self.shapes[j]
        n = len(s.tokens)
        if s.prefix_id >= 0:
            t = self.templates[s.prefix_id]
            tokens = np.concatenate([t, self.rng.integers(0, self.vocab, size=n - len(t)).astype(np.int32)])
        else:
            tokens = self.rng.integers(0, self.vocab, size=n).astype(np.int32)
        tokens, dl = fit(tokens, s.decode_len, self.max_len)
        item = Item(self.made, tokens, dl, s.prefix_id, float(self.gaps[j]))
        self.made += 1
        return item

    def longest_prompt(self) -> int:
        return max(len(fit(s.tokens, s.decode_len, self.max_len)[0]) for s in self.shapes)
