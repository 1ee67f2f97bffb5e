"""PyTorch/CUDA port of the ``repro`` serving stack, for one NVIDIA H100.

It sits beside the JAX package, which stays the reference it is held
against, and imports nothing from it: the pure-Python modules it needs
(configs, core, data, obs, env) are copies whose only change is their
import lines. Plain tensor code is PyTorch; each Pallas TPU kernel on the
ported path is a hand-written CUDA kernel under ``csrc/``. Entry points run
on the card unless the caller passes ``device="cpu"`` (see ``device.py``).
"""
