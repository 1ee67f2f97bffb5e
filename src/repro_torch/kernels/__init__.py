"""Hand-written Hopper kernels for the port, one subpackage per TPU kernel family.

Each subpackage: ops.py (the public wrappers: input checks, device routing,
launch counts), ref.py (the plain PyTorch version each kernel is held
against). The CUDA sources live in ``repro_torch/csrc/`` and are built by
``build.py`` with nvcc at first use.

tiered_gather   — near/far tiered row gather: tier resolve + select + int8
                  far-tier dequant + on-device hit counting; the serving
                  engine's device-tiering path (runtime/tiered_kv)
flash_attention — blocked causal/non-causal attention forward with GQA, the
                  dense model's prefill attention on the card
paged_attention — one-query GQA decode attention over a paged K/V pool, the
                  dense model's decode attention on the card, over the
                  per-slot cache viewed as pages (``cache_as_pages``)
"""
