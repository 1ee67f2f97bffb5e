"""Tier plane (``runtime/tiered_kv.py``): device milliseconds of the store's
``lookup_segments`` (B1 and the counter plane's updates), a step, between
CUDA events around the call, over the window. Moves itl_p95_ms."""


def read(ctx):
    ms = ctx.run.lookup_ms
    return sum(ms) / len(ms) if ms else None
