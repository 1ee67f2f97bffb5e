from repro_torch.kernels.mamba2_scan.ops import LAUNCHES, ssd_chunked  # noqa: F401
from repro_torch.kernels.mamba2_scan.ref import split_count, ssd_ref, ssd_split_ref  # noqa: F401
