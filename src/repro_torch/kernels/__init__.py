"""Hand-written Hopper kernels for the port, one subpackage per TPU kernel family.

Each subpackage: ops.py (the public wrappers: input checks, device routing,
launch counts), ref.py (the plain PyTorch version each kernel is held
against). The CUDA sources live in ``repro_torch/csrc/`` and are built by
``build.py`` with nvcc at first use.

tiered_gather   — near/far tiered row gather: tier resolve + select + int8
                  far-tier dequant + on-device hit counting; the serving
                  engine's device-tiering path (runtime/tiered_kv)
flash_attention — blocked causal/non-causal attention forward with GQA, the
                  prefill attention on the card of the dense model and of
                  zamba2's shared block, and the training forward's
                  attention (with its softmax stats, for the backward)
paged_attention — one-query GQA decode attention over a paged K/V pool, the
                  decode attention on the card of the dense model and of
                  zamba2's shared block, over the per-slot cache viewed as
                  pages (``cache_as_pages``)
rwkv6_scan      — chunked WKV6 with per-channel decay and a carried (hd, hd)
                  state, rwkv6's time-mix recurrence in prefill and decode
mamba2_scan     — chunked Mamba2 SSD with a scalar per-head decay and a
                  carried (P, N) state, zamba2's Mamba2 layers
"""


def launch_counts() -> dict:
    """Every kernel wrapper's ``LAUNCHES``, merged into one dict of ints (a
    copy). They count eager launches and captures, not graph replays
    (``runtime.graphs``)."""
    from repro_torch.kernels import (flash_attention, mamba2_scan, paged_attention, rwkv6_scan,
                                     tiered_gather)

    return {k: v for mod in (tiered_gather, flash_attention, paged_attention, rwkv6_scan, mamba2_scan)
            for k, v in mod.LAUNCHES.items()}
