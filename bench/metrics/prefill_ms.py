"""Model (``models/api.py`` ``prefill``): device milliseconds of one
whole-slot prefill, between CUDA events around ``ModelAPI.prefill``, the
mean over the window's prefills. Moves ttft_p95_ms."""


def read(ctx):
    ms = ctx.run.prefill_ms
    return sum(ms) / len(ms) if ms else None
