"""Device time of one kernel call, as ``chip_smoke.py`` and
``repro_torch.kernels.compare`` take it."""
from __future__ import annotations

import statistics

import torch


def time_ms(fn, reps: int = 60) -> float:
    """Median device time of one call of ``fn``, over ``reps`` calls.

    Before each call a 256 MB write evicts the 50 MB L2 (the serving step
    finds the store cold: the model's weights pass through in between) and
    a spin kernel holds the stream while the host enqueues the call, so the
    two events bracket the call's device work and not the host's."""
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)
