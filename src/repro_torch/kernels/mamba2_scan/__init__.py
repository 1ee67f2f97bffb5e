from repro_torch.kernels.mamba2_scan.ops import LAUNCHES, SSDFn, ssd_chunked, ssd_train  # noqa: F401
from repro_torch.kernels.mamba2_scan.ref import split_count, ssd_ref, ssd_split_ref, ssd_vjp  # noqa: F401
