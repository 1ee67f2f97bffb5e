"""Device (``runtime/graphs.py`` and every launch): the share of the traced
stretch with no kernel, copy or set running on the card, in percent, from
``torch.profiler``. Moves decode_tok_s."""


def read(ctx):
    s = ctx.summary
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
