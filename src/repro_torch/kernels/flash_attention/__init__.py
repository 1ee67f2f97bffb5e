from repro_torch.kernels.flash_attention.ops import LAUNCHES, flash_attention  # noqa: F401
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    flash_attention_ref,
    flash_attention_tf32_ref,
    flash_attention_tiled_ref,
)
