"""Kernel B5 (``kernels/flash_attention``), a whole-slot prefill's causal
attention. Moves ttft_p95_ms. Its share of its roofline over the traced
stretch (``harness/roofline.py``), in percent."""

from bench.harness.roofline import share


def read(ctx):
    return share(ctx, "flash_attention", ("fa_tc_kernel",))
