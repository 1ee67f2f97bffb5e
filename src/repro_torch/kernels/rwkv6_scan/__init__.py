from repro_torch.kernels.rwkv6_scan.ops import LAUNCHES, wkv6_chunked  # noqa: F401
from repro_torch.kernels.rwkv6_scan.ref import split_count, wkv6_ref, wkv6_split_ref  # noqa: F401
