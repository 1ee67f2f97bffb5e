from repro_torch.kernels.tiered_gather.ops import (  # noqa: F401
    LAUNCHES,
    gather_rows,
    tiered_lookup_counted,
    tiered_lookup_segments,
)
from repro_torch.kernels.tiered_gather.ref import (  # noqa: F401
    gather_rows_ref,
    tiered_lookup_counted_ref,
    tiered_lookup_ref,
    tiered_lookup_segments_ref,
)
