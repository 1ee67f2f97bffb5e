"""Production memory tracing (paper §6.2-§6.3): windowed attach/detach block
traces + the cache-simulator validation of Table 6.

The paper's PIN tool attaches for microseconds, detaches, and stitches many
short windows from multiple hosts into one representative trace, validated by
replaying it through a cache simulator and comparing the L1D hit ratio and
R:W ratio against production counters (errors <= ~5%).

Here the tracer attaches to the serving/training engine's block-access
stream for ``window_len`` steps every ``period`` steps (overhead bound =
window_len / period), stitches windows, and ``CacheSim`` replays the stitched
trace through an LRU block cache to validate against live statistics.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class TraceWindow:
    start_step: int
    blocks: np.ndarray  # int64
    is_write: np.ndarray  # bool
    # per-access stream id (decode slot / request / trace lane), int64.
    # None on traces recorded before stream tagging; consumers must treat
    # that as "one unknown stream", never as "stream 0 of many" — training
    # per-stream predictors on an untagged interleaved trace is exactly the
    # aggregate-stream contamination core/prefetch.py exists to avoid.
    stream: Optional[np.ndarray] = None


class MemTracer:
    def __init__(self, window_len: int = 20, period: int = 100):
        assert window_len <= period
        self.window_len = window_len
        self.period = period
        self.step = 0
        self._open: Optional[list] = None
        self._open_start = 0
        self.windows: List[TraceWindow] = []

    @property
    def attached(self) -> bool:
        return self.step % self.period < self.window_len

    def tick(self):
        self.step += 1

    def record(self, blocks, is_write=False, stream=0):
        """Called by the engine for every batch of block accesses; cheap
        (appends) only while attached — the low-overhead property.

        ``stream`` tags every access in the batch with the logical stream
        it belongs to (decode slot / request id) so trace consumers — the
        prefetcher's successor training above all — can recover per-stream
        order from the interleaved window."""
        if not self.attached:
            if self._open is not None:
                self._flush()
            return
        if self._open is None:
            self._open = []
            self._open_start = self.step
        b = np.asarray(blocks).reshape(-1)
        w = np.broadcast_to(np.asarray(is_write), b.shape)
        s = np.broadcast_to(np.asarray(stream), b.shape)
        self._open.append((b.astype(np.int64), w.astype(bool), s.astype(np.int64)))

    def _flush(self):
        if self._open:
            bs = np.concatenate([x[0] for x in self._open])
            ws = np.concatenate([x[1] for x in self._open])
            ss = np.concatenate([x[2] for x in self._open])
            self.windows.append(TraceWindow(self._open_start, bs, ws, ss))
        self._open = None

    def stitch(self) -> TraceWindow:
        """Concatenate all windows into one representative trace."""
        if self._open is not None:
            self._flush()
        if not self.windows:
            return TraceWindow(
                0, np.zeros(0, np.int64), np.zeros(0, bool), np.zeros(0, np.int64)
            )
        streams = [
            w.stream
            if w.stream is not None
            else np.zeros(w.blocks.size, np.int64)
            for w in self.windows
        ]
        return TraceWindow(
            self.windows[0].start_step,
            np.concatenate([w.blocks for w in self.windows]),
            np.concatenate([w.is_write for w in self.windows]),
            np.concatenate(streams),
        )

    def overhead_frac(self) -> float:
        return self.window_len / self.period


class CacheSim:
    """LRU block cache (the paper's 'simple cache simulator')."""

    def __init__(self, capacity_blocks: int):
        self.capacity = capacity_blocks
        self.lru: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def access(self, block: int):
        if block in self.lru:
            self.lru.move_to_end(block)
            self.hits += 1
        else:
            self.misses += 1
            self.lru[block] = True
            if len(self.lru) > self.capacity:
                self.lru.popitem(last=False)

    def run(self, trace: TraceWindow) -> dict:
        for b in trace.blocks:
            self.access(int(b))
        reads = int((~trace.is_write).sum())
        writes = int(trace.is_write.sum())
        return {
            "hit_ratio": self.hits / max(self.hits + self.misses, 1),
            "rw_ratio": reads / max(writes, 1),
        }


def validate_trace(trace: TraceWindow, live_hit_ratio: float, live_rw_ratio: float, capacity_blocks: int) -> dict:
    """Table 6: simulated-vs-live hit ratio and R:W errors."""
    sim = CacheSim(capacity_blocks).run(trace)
    return {
        "sim_hit_ratio": sim["hit_ratio"],
        "live_hit_ratio": live_hit_ratio,
        "hit_ratio_error": abs(sim["hit_ratio"] - live_hit_ratio),
        "sim_rw_ratio": sim["rw_ratio"],
        "live_rw_ratio": live_rw_ratio,
        "rw_ratio_error_pct": 100.0 * (sim["rw_ratio"] - live_rw_ratio) / max(live_rw_ratio, 1e-9),
    }
