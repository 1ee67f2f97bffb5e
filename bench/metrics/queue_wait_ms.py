"""Admission (``runtime/serving.py`` ``submit``, ``_admit``): the p95 of the
window's ``queue`` spans on the engine's device timeline, a request's wait
from ``submit`` (host clock) to the device start of its prefill (whole-slot)
or its admission (chunked), in ms, over the spans that end in the window.
Moves ttft_p95_ms. None from an engine without a timeline."""
from bench.harness.timeline import percentile


def read(ctx):
    timeline = getattr(ctx.run.eng, "timeline", None)
    if timeline is None:
        return None
    ms = [1e3 * s.dur for s in timeline(ctx.t_open, ctx.t_close) if s.name == "queue"]
    return percentile(ms, 95) if ms else None
