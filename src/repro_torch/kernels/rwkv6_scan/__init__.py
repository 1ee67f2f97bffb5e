from repro_torch.kernels.rwkv6_scan.ops import LAUNCHES, WKV6Fn, wkv6_chunked, wkv6_train  # noqa: F401
from repro_torch.kernels.rwkv6_scan.ref import split_count, wkv6_ref, wkv6_split_ref, wkv6_vjp  # noqa: F401
