"""Deterministic synthetic corpus.

Token stream with (a) a Zipfian unigram marginal — so embedding-row access
skew is realistic for the tiering study (the paper's "few pages serve most
bandwidth" shows up in the embedding table exactly when token frequencies are
Zipf) — and (b) short-range structure (repeated n-grams) so loss actually
falls during the example training runs.

Everything is derived from (seed, shard, index): any host can regenerate any
batch, which is what makes checkpoint/restart and elastic re-sharding exact
(the loader stores only integer cursors).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticCorpus:
    vocab_size: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.2
    motif_len: int = 8
    n_motifs: int = 512

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # Zipf-ranked token ids: rank r -> token id perm[r]
        self._perm = rng.permutation(self.vocab_size)
        ranks = np.arange(1, self.vocab_size + 1, dtype=np.float64)
        probs = ranks ** (-self.zipf_a)
        self._probs = probs / probs.sum()
        self._motifs = rng.integers(
            0, self.vocab_size, size=(self.n_motifs, self.motif_len), dtype=np.int64
        )

    def sequence(self, index: int) -> np.ndarray:
        """Deterministic sequence ``index`` -> int32 (seq_len + 1,) tokens."""
        rng = np.random.default_rng((self.seed << 20) ^ (index & 0xFFFFF) ^ (index >> 20))
        n = self.seq_len + 1
        ranks = rng.choice(self.vocab_size, size=n, p=self._probs)
        toks = self._perm[ranks]
        # overwrite ~25% of positions with motifs (predictable structure)
        n_spans = max(1, n // (self.motif_len * 4))
        starts = rng.integers(0, max(1, n - self.motif_len), size=n_spans)
        which = rng.integers(0, self.n_motifs, size=n_spans)
        for s, w in zip(starts, which):
            toks[s : s + self.motif_len] = self._motifs[w][: n - s]
        return toks.astype(np.int32)

    def batch(self, indices: np.ndarray) -> dict:
        seqs = np.stack([self.sequence(int(i)) for i in indices])
        return {"tokens": seqs[:, :-1], "labels": seqs[:, 1:].astype(np.int32)}


def token_batches(corpus: SyntheticCorpus, batch_size: int, start_step: int = 0):
    """Infinite deterministic batch iterator (global indexing)."""
    step = start_step
    while True:
        idx = np.arange(step * batch_size, (step + 1) * batch_size)
        yield step, corpus.batch(idx)
        step += 1
