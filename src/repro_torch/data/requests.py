"""Serving request generator driven by the nine workload profiles.

Web-like profiles draw most prompts from a shared prefix pool (the paper's
"cores run the same code" in request form: many requests, same template),
cache-like profiles are Zipf-skewed point lookups, Reader is long-prompt
backend-bound. Deterministic per (profile, seed, index).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.configs.workloads import WorkloadProfile


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray  # prompt token ids (int32)
    decode_len: int
    prefix_id: int  # -1 if unique prompt
    arrival: float
    tenant: str = "default"  # service identity for multi-tenant fleets


@dataclasses.dataclass
class ChunkState:
    """Prefill progress of one admitted request under chunked prefill.

    The continuous-batching engine splits a prompt into fixed-token-budget
    chunks interleaved with decode inside the same segmented dispatch; this
    tracks how far the prompt has been fed. ``pos`` counts tokens already
    written into the slot's KV cache; the request leaves the prefill phase
    when ``done`` (its first generated token is emitted by the same step
    that consumed the final prompt token).
    """

    tokens: np.ndarray  # the (possibly truncated) prompt being prefilled
    pos: int = 0  # prompt tokens already prefilled into the slot

    @property
    def total(self) -> int:
        return len(self.tokens)

    @property
    def remaining(self) -> int:
        return self.total - self.pos

    @property
    def done(self) -> bool:
        return self.pos >= self.total

    def take(self, budget: int) -> np.ndarray:
        """Next chunk of at most ``budget`` tokens (does NOT advance ``pos``;
        the engine advances only after the dispatch lands)."""
        assert budget > 0, budget
        return self.tokens[self.pos : self.pos + budget]


class RequestGenerator:
    def __init__(
        self,
        profile: WorkloadProfile,
        vocab_size: int,
        seed: int = 0,
        rate: float = 8.0,
        tenant: Optional[str] = None,
    ):
        self.p = profile
        self.vocab = vocab_size
        self.tenant = tenant if tenant is not None else "default"
        self.rng = np.random.default_rng(seed)
        self.rate = rate
        self._prefixes = [
            self.rng.integers(0, vocab_size, size=max(8, int(profile.prompt_mean * 0.75)))
            .astype(np.int32)
            for _ in range(profile.n_prefixes)
        ]
        # Zipf over prefixes too: hot templates dominate (Web1's correlation)
        ranks = np.arange(1, profile.n_prefixes + 1, dtype=np.float64)
        pz = ranks ** -max(profile.zipf_alpha, 0.5)
        self._prefix_probs = pz / pz.sum()
        self._next_id = 0
        self._clock = 0.0

    def __iter__(self) -> Iterator[Request]:
        return self

    def __next__(self) -> Request:
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
        return Request(rid, tokens, decode_len, pid, self._clock, self.tenant)

    def block_stream(
        self,
        n: int,
        n_blocks: Optional[int] = None,
        n_streams: int = 4,
        return_lanes: bool = False,
    ) -> np.ndarray:
        """State-block access stream for this service — MemProf.MemBW's
        sampled miss stream.

        Structure mirrors a serving engine's memory behavior: ``n_streams``
        concurrent sequences each walk blocks SEQUENTIALLY (a KV page walk)
        and re-seed at a Zipf-hot block with probability ``seq_jump`` —
        low-jump services (Ads1, CPU inference) are stream-prefetchable,
        high-jump ones (Cache1/2 key-value lookups) are not (Fig. 21/22).

        ``return_lanes=True`` also returns the per-access lane (stream) id —
        the per-stream tag a trace-driven prefetcher trains on; without it a
        consumer sees the interleaved aggregate, which is exactly the
        mistraining hazard core/prefetch.py documents.
        """
        nb = n_blocks or self.p.n_blocks
        ranks = np.arange(1, nb + 1, dtype=np.float64)
        probs = ranks ** -self.p.zipf_alpha
        probs /= probs.sum()
        perm = np.random.default_rng(hash(self.p.name) % 2**31).permutation(nb)
        seeds = perm[self.rng.choice(nb, size=n, p=probs)]  # zipf-hot restarts
        pos = seeds[: n_streams].astype(np.int64).copy()
        jump = self.rng.random(n) < self.p.seq_jump
        lane = self.rng.integers(0, n_streams, n)
        out = np.empty(n, np.int64)
        for i in range(n):
            s = lane[i]
            if jump[i]:
                pos[s] = seeds[i]
            else:
                pos[s] = (pos[s] + 1) % nb
            out[i] = pos[s]
        if return_lanes:
            return out, lane.astype(np.int64)
        return out

    def template_stream(
        self,
        n: int,
        n_blocks: Optional[int] = None,
        n_templates: int = 8,
        template_len: int = 12,
        suffix_len: int = 4,
        n_streams: int = 4,
        phases: int = 1,
    ):
        """Paged-KV template walk: the stream shape trace-driven prefetch wins.

        Real serving traffic re-walks hot prompt TEMPLATES: a request reads
        its template's page chain, then a short private suffix. Crucially
        the chain's physical page ids are SCATTERED — the pagetable
        allocated them whenever the template first appeared, so consecutive
        chain pages are not consecutive ids. A nextline/stride prefetcher
        gets ~nothing from the chain (the successor of page 731 is page 88),
        an online markov table must re-learn every chain per run under its
        confidence gates, but a successor table trained on stream-tagged
        trace windows covers every repeat of a chain seen anywhere in the
        fleet. Suffix pages are private and unpredictable for everyone —
        they keep accuracy honest.

        ``phases > 1`` re-draws template popularity every ``n/phases``
        accesses (the phase-shifting workload of the tiered-decode bench):
        hotness moves but the CHAINS persist, so trained successors stay
        valid across phases while pure-hotness placement lags each shift.

        Returns ``(blocks, lanes)`` — int64 arrays; ``lanes`` tags each
        access with its stream (decode slot analogue).
        """
        nb = n_blocks or self.p.n_blocks
        need = n_templates * template_len
        assert need < nb, "template chains must fit the block space"
        perm = self.rng.permutation(nb)
        chains = perm[:need].reshape(n_templates, template_len)
        pool = perm[need:]
        ranks = np.arange(1, n_templates + 1, dtype=np.float64)
        pz = ranks ** -max(self.p.zipf_alpha, 0.8)
        pz /= pz.sum()
        order = np.arange(n_templates)
        phase_len = max(1, n // max(1, phases))
        out = np.empty(n, np.int64)
        lanes = np.empty(n, np.int64)
        cur = [np.empty(0, np.int64) for _ in range(n_streams)]
        pos = [0] * n_streams
        for i in range(n):
            if phases > 1 and i > 0 and i % phase_len == 0:
                # popularity rotates; the chains themselves persist
                order = self.rng.permutation(n_templates)
            lane = int(self.rng.integers(0, n_streams))
            if pos[lane] >= cur[lane].size:
                t = int(order[self.rng.choice(n_templates, p=pz)])
                sfx = self.rng.choice(pool, size=suffix_len, replace=False)
                cur[lane] = np.concatenate([chains[t], sfx.astype(np.int64)])
                pos[lane] = 0
            out[i] = cur[lane][pos[lane]]
            lanes[i] = lane
            pos[lane] += 1
        return out, lanes


def interleave(gens: Sequence[RequestGenerator], n: int) -> List[Request]:
    """Merge ``n`` requests from several tenant generators by arrival time.

    The co-location traffic model: each tenant keeps its own Poisson clock
    and the fleet sees the time-ordered merge. Request ids are reassigned so
    sequence ids stay unique fleet-wide, and shared-prefix ids are namespaced
    per tenant so one tenant's hot template can't alias another's in
    prefix-affinity routing. Deterministic given the generators' seeds.
    """
    heads = [next(g) for g in gens]
    out: List[Request] = []
    for rid in range(n):
        g = min(range(len(gens)), key=lambda i: (heads[i].arrival, i))
        req = heads[g]
        pid = req.prefix_id if req.prefix_id < 0 else req.prefix_id * len(gens) + g
        out.append(dataclasses.replace(req, rid=rid, prefix_id=pid))
        heads[g] = next(gens[g])
    return out
