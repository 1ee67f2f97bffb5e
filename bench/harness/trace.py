"""The traced window: ``torch.profiler`` over a stretch of the window, read
into device busy time, kernel time by name, and the idle gaps labelled by
what the host was doing (the harness's ranges around its own steps, and
the innermost host operation under them)."""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Iterable, List, Tuple

import torch

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
RANGE_PREFIX = "bench."  # the harness's own host ranges


@dataclasses.dataclass
class TraceSummary:
    window_s: float  # host clock, profiler start to stop (each after a synchronize)
    busy_s: float  # union of the device's kernel, copy and set intervals
    kernel_s: Dict[str, float]  # device seconds by kernel name
    device_ops: List[Tuple[str, float]]  # top 10 by seconds
    idle_gaps: List[Tuple[str, float]]  # top 10 host activities by idle seconds under them

    def kernel_seconds(self, patterns: Iterable[str]) -> float:
        """Device seconds of every kernel whose name holds one of ``patterns``."""
        pats = tuple(patterns)
        return sum(s for n, s in self.kernel_s.items() if any(p in n for p in pats))


def _union(intervals: List[Tuple[float, float]]):
    """(busy seconds, gaps [(start, end)]) of sorted (start, end) intervals."""
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


def _labels(mids: List[float], host: List[Tuple[float, float, str, bool]]) -> List[str]:
    """For each of the sorted times ``mids``: the innermost harness range and
    the innermost host op covering it (``host`` sorted by start), by one
    sweep."""
    out, active, i = [], [], 0
    for mid in mids:
        while i < len(host) and host[i][0] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= mid]
        rng = min((h for h in active if h[3]), key=lambda h: h[1] - h[0], default=None)
        op = min((h for h in active if not h[3]), key=lambda h: h[1] - h[0], default=None)
        out.append(f"{rng[2] if rng else 'no harness range'} / {op[2] if op else 'no host op'}")
    return out


def summarize(prof, window_s: float) -> TraceSummary:
    """Read a stopped ``torch.profiler.profile``'s events (times in us)."""
    dev, host = [], []
    kernel_s: Dict[str, float] = collections.defaultdict(float)
    for ev in prof.events():
        start = ev.time_range.start * 1e-6
        end = ev.time_range.end * 1e-6
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            # a host range's projection onto the device timeline is no work
            if end > start and not ev.name.startswith(RANGE_PREFIX):
                dev.append((start, end))
                kernel_s[ev.name] += end - start
        else:
            host.append((start, end, ev.name, ev.name.startswith(RANGE_PREFIX)))
    busy, gaps = _union(dev)
    idle: Dict[str, float] = collections.defaultdict(float)
    host.sort()
    for (s, e), label in zip(gaps, _labels([0.5 * (s + e) for s, e in gaps], host)):
        idle[label] += e - s
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:10]
    return TraceSummary(window_s, busy, dict(kernel_s), top(kernel_s), top(idle))
