"""The end-to-end numbers from a run's timeline, on one clock: pure
arithmetic over plain lists, so that a test can feed it a synthetic run."""
from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List, Optional


@dataclasses.dataclass
class RequestTimes:
    """One request: when it was sent (its due time in an open loop, the end
    of its client's previous request in a closed one) and when each of its
    output tokens existed, in seconds on the harness's clock."""

    send: float
    tokens: List[float]


def percentile(xs: List[float], q: float) -> float:
    """The ``q``-th percentile (0-100), linear between order statistics."""
    s = sorted(xs)
    if not s:
        raise ValueError("no samples")
    pos = (len(s) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def in_window(t: float, t_open: float, t_close: float) -> bool:
    return t_open <= t <= t_close


def ttft_samples(reqs: List[RequestTimes], t_open: float, t_close: float) -> List[float]:
    """Send to first token, of every request whose first token lands in the window."""
    return [r.tokens[0] - r.send for r in reqs if r.tokens and in_window(r.tokens[0], t_open, t_close)]


def itl_samples(reqs: List[RequestTimes], t_open: float, t_close: float) -> List[float]:
    """Every gap between consecutive output tokens of one request whose later
    token lands in the window."""
    out = []
    for r in reqs:
        for a, b in zip(r.tokens, r.tokens[1:]):
            if in_window(b, t_open, t_close):
                out.append(b - a)
    return out


def tokens_in_window(reqs: List[RequestTimes], t_open: float, t_close: float) -> int:
    return sum(in_window(t, t_open, t_close) for r in reqs for t in r.tokens)


def end_to_end(reqs: List[RequestTimes], t_open: float, t_close: float) -> Dict[str, Optional[float]]:
    """decode_tok_s, ttft_p95_ms, itl_p95_ms and the medians beside them."""
    ttft = ttft_samples(reqs, t_open, t_close)
    itl = itl_samples(reqs, t_open, t_close)
    out = {"decode_tok_s": tokens_in_window(reqs, t_open, t_close) / (t_close - t_open),
           "ttft_samples": len(ttft), "itl_samples": len(itl)}
    for name, xs in (("ttft", ttft), ("itl", itl)):
        out[f"{name}_p50_ms"] = 1e3 * statistics.median(xs) if xs else None
        out[f"{name}_p95_ms"] = 1e3 * percentile(xs, 95) if xs else None
    return out
