"""Tier plane boundary (the engine's placement-window boundary: the counter
plane's drain, the TPP epoch, its migrations, the prefetch window): the
mean device length of the window's ``epoch`` spans on the engine's device
timeline, in ms. Moves decode_tok_s. None from an engine without a
timeline."""


def read(ctx):
    timeline = getattr(ctx.run.eng, "timeline", None)
    if timeline is None:
        return None
    ms = [1e3 * s.dur for s in timeline(ctx.t_open, ctx.t_close) if s.name == "epoch"]
    return sum(ms) / len(ms) if ms else None
