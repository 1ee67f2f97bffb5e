"""Shared KV page table — the paper's multi-ASID shared L2 I-TLB, in KV form.

The paper lets one TLB entry carry multiple ASIDs so processes running the
same code share translations. Here one PHYSICAL KV page can be mapped by
multiple SEQUENCES (the entry's "ASID list" is its refcount + owner set):
common prompt prefixes are detected by a chunk-hash chain and mapped to the
same physical page, deduplicating both capacity and the prefill bandwidth of
recomputing shared prefixes.

Pages also carry a tier bit (near=HBM / far=host), making this table the
single source of truth for the serving engine's placement + the dense
page-table array consumed by kernels/paged_attention.

Copy-on-write: appending into a partially-filled SHARED page forks it first
(same rule as a TLB entry split on ASID divergence).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

NEAR, FAR = 0, 1


@dataclasses.dataclass
class PhysPage:
    pid: int
    ref: int = 0
    tier: int = NEAR
    chain_hash: Optional[int] = None  # prefix-identity of a FULL page
    fill: int = 0  # tokens written (== page_size when full)


class SharedKVPageTable:
    def __init__(self, n_pages: int, page_size: int):
        self.page_size = page_size
        self.n_pages = n_pages
        self.pages: List[PhysPage] = [PhysPage(i) for i in range(n_pages)]
        self.free: List[int] = list(range(n_pages - 1, -1, -1))
        self.seqs: Dict[int, List[int]] = {}  # seq id -> [phys page ids]
        self.seq_len: Dict[int, int] = {}
        self.chains: Dict[int, int] = {}  # chain_hash -> phys id (full pages)
        # counters
        self.shared_mappings = 0  # pages shared instead of allocated (TLB "hits")
        self.cow_copies = 0
        self.alloc_count = 0

    # ------------------------------------------------------------------
    def _alloc(self) -> int:
        if not self.free:
            raise MemoryError("KV page pool exhausted")
        pid = self.free.pop()
        pg = self.pages[pid]
        pg.ref = 1
        pg.chain_hash = None
        pg.fill = 0
        pg.tier = NEAR
        self.alloc_count += 1
        return pid

    def _decref(self, pid: int):
        pg = self.pages[pid]
        pg.ref -= 1
        if pg.ref == 0:
            if pg.chain_hash is not None:
                self.chains.pop(pg.chain_hash, None)
            pg.chain_hash = None
            self.free.append(pid)

    @staticmethod
    def _chain(prev: int, tokens: Sequence[int]) -> int:
        return hash((prev,) + tuple(int(t) for t in tokens))

    # ------------------------------------------------------------------
    def add_sequence(self, seq_id: int, tokens: Sequence[int]) -> dict:
        """Map a new sequence; share full prefix pages when the chunk-hash
        chain matches an existing resident page. Returns sharing stats.

        Only fully-filled pages are sharable (a partial tail page is private).
        """
        assert seq_id not in self.seqs
        ps = self.page_size
        pages: List[int] = []
        shared = 0
        chain = 0
        n_full = len(tokens) // ps
        for i in range(n_full):
            chunk = tokens[i * ps : (i + 1) * ps]
            chain = self._chain(chain, chunk)
            pid = self.chains.get(chain)
            if pid is not None and self.pages[pid].ref > 0:
                self.pages[pid].ref += 1
                shared += 1
                self.shared_mappings += 1
            else:
                pid = self._alloc()
                self.pages[pid].fill = ps
                self.pages[pid].chain_hash = chain
                self.chains[chain] = pid
            pages.append(pid)
        rem = len(tokens) - n_full * ps
        if rem:
            pid = self._alloc()
            self.pages[pid].fill = rem
            pages.append(pid)
        self.seqs[seq_id] = pages
        self.seq_len[seq_id] = len(tokens)
        return {"pages": len(pages), "shared": shared, "new": len(pages) - shared}

    def append_token(self, seq_id: int) -> int:
        """Advance a sequence by one decoded token; returns the physical page
        written (with copy-on-write if the tail page is shared)."""
        pages = self.seqs[seq_id]
        pos = self.seq_len[seq_id]
        if pos % self.page_size == 0:  # need a fresh page
            pid = self._alloc()
            pages.append(pid)
        else:
            pid = pages[-1]
            pg = self.pages[pid]
            if pg.ref > 1:  # COW fork
                new = self._alloc()
                self.pages[new].fill = pg.fill
                self._decref(pid)
                pages[-1] = new
                pid = new
                self.cow_copies += 1
        self.pages[pid].fill = pos % self.page_size + 1
        self.seq_len[seq_id] = pos + 1
        return pid

    def free_sequence(self, seq_id: int):
        for pid in self.seqs.pop(seq_id):
            self._decref(pid)
        self.seq_len.pop(seq_id)

    # ------------------------------------------------------------------
    def dense_table(self, seq_ids: Sequence[int], pages_per_seq: int) -> np.ndarray:
        """(B, pages_per_seq) int32 physical-page table for the kernel."""
        out = np.zeros((len(seq_ids), pages_per_seq), np.int32)
        for i, sid in enumerate(seq_ids):
            pl = self.seqs[sid][:pages_per_seq]
            out[i, : len(pl)] = pl
        return out

    def lengths(self, seq_ids: Sequence[int]) -> np.ndarray:
        return np.array([self.seq_len[s] for s in seq_ids], np.int32)

    # ------------------------------------------------------------------
    def set_tier(self, pid: int, tier: int):
        self.pages[pid].tier = tier

    def tier_of(self, pids) -> np.ndarray:
        return np.array([self.pages[p].tier for p in np.asarray(pids).reshape(-1)], np.int8)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self.free)

    def stats(self) -> dict:
        refs = [p.ref for p in self.pages if p.ref > 0]
        return {
            "used_pages": self.used_pages,
            "free_pages": len(self.free),
            "shared_mappings": self.shared_mappings,
            "cow_copies": self.cow_copies,
            "max_ref": max(refs, default=0),
            "alloc_count": self.alloc_count,
            "dedup_ratio": (self.shared_mappings + self.used_pages) / max(self.used_pages, 1),
        }
