"""Tier plane (``runtime/tiered_kv.py``, at the engine's call): the mean
device length of the window's ``lookup`` spans on the engine's device
timeline, one a step (B1 and the counter plane's updates), in ms. Moves
itl_p95_ms. None from an engine without a timeline."""


def read(ctx):
    timeline = getattr(ctx.run.eng, "timeline", None)
    if timeline is None:
        return None
    ms = [1e3 * s.dur for s in timeline(ctx.t_open, ctx.t_close) if s.name == "lookup"]
    return sum(ms) / len(ms) if ms else None
