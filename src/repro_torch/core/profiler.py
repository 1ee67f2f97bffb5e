"""MemProf analogue: block-granular access profiling for framework state.

The paper samples I-TLB misses (MemProf.Code) and LLC demand misses
(MemProf.MemBW) and aggregates per page. Here the instrumented "pages" are
the framework's state blocks — KV-cache pages, MoE experts, embedding rows,
parameter shards — and the "cores" are streams (DP replicas, request lanes).

Three probes, mirroring Fig. 6:
  * Code  -> ``record`` on parameter-block reads per replica stream;
             ``correlation`` reproduces Table 2, ``bandwidth_cdf`` Fig. 9.
  * MemBW -> ``record`` on KV/expert/embedding accesses; windowed counts
             give Fig. 18's interval study and feed the tier planner.
  * MemLat-> prefetcher accounting lives in core/prefetch.py; the profiler
             only aggregates its counters into the report.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

import numpy as np

from repro_torch.core import distribution


@dataclasses.dataclass
class StreamStats:
    counts: np.ndarray  # (n_blocks,) total
    reads: int = 0
    writes: int = 0


class AccessProfiler:
    """Counts block accesses per stream, with measurement windows.

    ``window_len`` (in record-steps) splits time into windows so
    interval-stability (Fig. 18) can be evaluated; window boundaries advance
    via ``tick()`` (one tick == one engine step).
    """

    def __init__(self, n_blocks: int, block_bytes: int = 4096, window_len: int = 30):
        self.n_blocks = n_blocks
        self.block_bytes = block_bytes
        self.window_len = window_len
        self._streams: Dict[str, StreamStats] = {}
        self._windows: Dict[str, list] = {}
        self._cur_win: Dict[str, np.ndarray] = {}
        self.step = 0

    # ------------------------------------------------------------------
    def _stream(self, name: str) -> StreamStats:
        if name not in self._streams:
            self._streams[name] = StreamStats(np.zeros(self.n_blocks, np.int64))
            self._windows[name] = []
            self._cur_win[name] = np.zeros(self.n_blocks, np.int64)
        return self._streams[name]

    def record(self, stream: str, block_ids, weights=None, rw: str = "r"):
        st = self._stream(stream)
        ids = np.asarray(block_ids).reshape(-1)
        if weights is None:
            np.add.at(st.counts, ids, 1)
            np.add.at(self._cur_win[stream], ids, 1)
            n = ids.size
        else:
            w = np.asarray(weights).reshape(-1)
            np.add.at(st.counts, ids, w)
            np.add.at(self._cur_win[stream], ids, w)
            n = int(w.sum())
        if rw == "r":
            st.reads += n
        else:
            st.writes += n

    def tick(self, n: int = 1):
        """Advance time; closes measurement windows at window_len boundaries."""
        for _ in range(n):
            self.step += 1
            if self.step % self.window_len == 0:
                for name, cur in self._cur_win.items():
                    self._windows[name].append(cur.copy())
                    cur[:] = 0

    # ------------------------------------------------------------------
    def streams(self, prefix: str = "") -> list:
        """Registered stream names, optionally filtered by prefix.

        Tenant-scoped streams use dotted names ("kv.web"); the fleet export
        enumerates them here instead of reaching into private state.
        """
        return sorted(n for n in self._streams if n.startswith(prefix))

    def counts(self, stream: str) -> np.ndarray:
        return self._stream(stream).counts

    def windows(self, stream: str) -> list:
        return self._windows.get(stream, [])

    def bandwidth_cdf(self, stream: str):
        return distribution.bandwidth_cdf(self.counts(stream))

    def hot_fraction(self, stream: str, capacity_frac: float) -> float:
        return distribution.hot_fraction(self.counts(stream), capacity_frac)

    def correlation(self, s1: str, s2: str) -> float:
        return distribution.pearson(self.counts(s1), self.counts(s2))

    def rw_ratio(self, stream: str) -> float:
        st = self._stream(stream)
        return st.reads / max(st.writes, 1)

    def bytes_accessed(self, stream: str) -> int:
        return int(self.counts(stream).sum()) * self.block_bytes

    # ------------------------------------------------------------------
    def report(self, capacity_fracs: Iterable[float] = (0.05, 0.1, 0.25)) -> dict:
        """The MemProf report: per stream, the hotness profile + stability."""
        out = {}
        for name, st in self._streams.items():
            counts = st.counts
            out[name] = {
                "total_accesses": int(counts.sum()),
                "active_frac": float((counts > 0).mean()),
                "hot": {f: distribution.hot_fraction(counts, f) for f in capacity_fracs},
                "capacity_for_90pct": distribution.capacity_for_traffic(counts, 0.9),
                "zipf_alpha": distribution.zipf_alpha(counts),
                "rw_ratio": self.rw_ratio(name),
                "stability": distribution.interval_stability(self.windows(name)),
            }
        return out
