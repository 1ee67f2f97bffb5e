"""Kernel B1 (``kernels/tiered_gather``), the step's segmented tiered lookup.
Moves itl_p95_ms. Its share of its roofline over the traced stretch
(``harness/roofline.py``), in percent."""

from bench.harness.roofline import share


def read(ctx):
    return share(ctx, "tiered_lookup", ("tiered_lookup_kernel",))
