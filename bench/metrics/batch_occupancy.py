"""Serving engine (``runtime/serving.py``): the slots each of the window's
engine steps decoded, over ``max_batch``, in percent. Moves decode_tok_s."""


def read(ctx):
    rows = ctx.run.rows[ctx.k_open: ctx.k_close]
    if not rows:
        return None
    return 100.0 * sum(rows) / (len(rows) * ctx.run.ecfg.max_batch)
