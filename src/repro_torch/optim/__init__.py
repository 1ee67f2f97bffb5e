"""Optimizer, LR schedules and gradient compression (mirrors repro/optim).

Parameters, gradients and optimizer moments are flat dicts of tensors keyed
by the port's ``state_dict`` names (``layers.<i>.attn.wq``, ...), the
reference's nested tree with its stacked layer axis split onto the layers.
"""
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.schedule import warmup_cosine  # noqa: F401
from repro_torch.optim.compression import compress_int8, decompress_int8  # noqa: F401
