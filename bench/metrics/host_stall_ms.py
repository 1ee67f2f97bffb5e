"""Engine host path (``runtime/serving.py`` admission, books, retire, TPP
plan): the device-clock length of a step's host-only spans on the engine's
device timeline, the time the card sat idle waiting on host work that
launches nothing, summed over the window's spans and divided by the
window's steps, in ms a step. Moves decode_tok_s. None from an engine
without a timeline."""


def read(ctx):
    timeline = getattr(ctx.run.eng, "timeline", None)
    if timeline is None:
        return None
    spans = timeline(ctx.t_open, ctx.t_close)
    steps = sum(1 for s in spans if s.name == "step")
    stall = sum(s.dur for s in spans if s.host_only)
    return 1e3 * stall / steps if steps else None
