"""Model (``models/api.py`` ``prefill``, from inside the engine): the mean
device length of the window's ``prefill.model`` spans on the engine's
device timeline, the whole-slot prefill's model call alone, in ms. Moves
ttft_p95_ms. None from an engine without a timeline."""


def read(ctx):
    timeline = getattr(ctx.run.eng, "timeline", None)
    if timeline is None:
        return None
    ms = [1e3 * s.dur for s in timeline(ctx.t_open, ctx.t_close) if s.name == "prefill.model"]
    return sum(ms) / len(ms) if ms else None
