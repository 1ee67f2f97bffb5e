"""Kernel B4 (``kernels/paged_attention``), decode attention over the paged
cache, with each step's lengths. Moves decode_tok_s. Its share of its
roofline over the traced stretch (``harness/roofline.py``), in percent."""

from bench.harness.roofline import share


def read(ctx):
    return share(ctx, "paged_attention", ("paged_decode_kernel",))
