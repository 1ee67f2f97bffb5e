"""Model step (``models/``): model FLOPs of the window's prompt and output
tokens (the family's ``flops_per_token``, ``bench/families/<family>.py``) over the window's seconds times the
card's bf16 peak (the configurations compute in bf16), in percent. Moves
decode_tok_s."""

from bench.frozen import peaks


def read(ctx):
    if ctx.model_flops <= 0:
        return None
    return 100.0 * ctx.model_flops / (ctx.window_s * peaks.PEAK_FLOPS_BF16)
