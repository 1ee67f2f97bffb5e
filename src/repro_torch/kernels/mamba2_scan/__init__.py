from repro_torch.kernels.mamba2_scan.ops import LAUNCHES, ssd_chunked  # noqa: F401
from repro_torch.kernels.mamba2_scan.ref import ssd_ref  # noqa: F401
