from repro_torch.kernels.rwkv6_scan.ops import LAUNCHES, wkv6_chunked  # noqa: F401
from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref  # noqa: F401
