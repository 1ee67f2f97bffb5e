from repro_torch.kernels.paged_attention.ops import (  # noqa: F401
    LAUNCHES,
    cache_as_pages,
    paged_attention,
)
from repro_torch.kernels.paged_attention.ref import (  # noqa: F401
    gather_pages,
    paged_attention_ref,
    paged_attention_split_ref,
    split_count,
)
