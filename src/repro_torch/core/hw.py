"""Hardware model: the card the port runs on + memory-tier specs.

The card's figures are its published peaks, for an NVIDIA H100 80GB HBM3,
700 W (the SXM part): 3.35 TB/s of HBM3 and 80 GiB of it, dense products
at 989 TFLOP/s in bf16 and 495 TFLOP/s in TF32 on the tensor cores and
67 TFLOP/s in f32 on the CUDA cores, NVLink 4 at 450 GB/s each way, and a
PCIe Gen5 x16 host link at 64 GB/s each way; across nodes of 8 cards (the
DGX H100 system), InfiniBand NDR at 400 Gb/s a card, 50 GB/s each way. The roofline
(``launch/roofline.py``) and the kernels' bounds (``kernels/work.py``)
price work at these peaks. Tier specs mirror the paper's Table 4 (near =
HB-DIMM-like: 2x BW, 2x cost; far = CXL-like: DDR BW, higher latency) as
the reference has them, so the planner reproduces Table 5 with the paper's
own constants; the serving tiers (device HBM vs host DRAM over the host
link) are the deployment analogue.
"""
from __future__ import annotations

import dataclasses

# --- NVIDIA H100 80GB HBM3, 700 W (published peaks) -------------------------
PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense bf16 on the tensor cores (H100 SXM, 700 W)
PEAK_FLOPS_TF32 = 495e12  # FLOP/s, dense TF32 on the tensor cores (H100 SXM, 700 W)
PEAK_FLOPS_FP32 = 67e12  # FLOP/s, f32 on the CUDA cores (H100 SXM, 700 W)
HBM_BW = 3.35e12  # B/s, HBM3 (H100 SXM, 700 W)
HBM_BYTES = 80 * 2**30  # the card's 80 GiB of HBM3 (H100 SXM, 700 W)
# NVLink 4, one direction, all 18 links of one card together (H100 SXM,
# 700 W): the counterpart of the reference's ICI link figure, the link a
# collective rides when its group lies inside one node (a DGX H100 system
# joins its 8 cards by NVLink)
NVLINK_BW = 450e9  # B/s
# InfiniBand NDR, one direction, one 400 Gb/s port a card (the DGX H100
# system's eight ConnectX-7 ports): the counterpart of the reference's
# cross-pod DCI figure, the link a collective rides when its group spans
# nodes
IB_BW = 50e9  # B/s
# host link (far tier for serving state): PCIe Gen5 x16, one direction
HOST_LINK_BW = 64e9  # B/s


@dataclasses.dataclass(frozen=True)
class TierSpec:
    name: str
    capacity_frac: float  # fraction of total workload memory capacity
    bw: float  # B/s usable peak
    latency_rel: float  # relative load latency (near == 1.0)
    cost_per_unit: float  # relative $ per byte (DDR == 1.0)

    @property
    def cost(self) -> float:
        return self.capacity_frac * self.cost_per_unit


# --- the paper's Table 4 configurations ------------------------------------
GB = 1e9
BASELINE = (TierSpec("ddr", 1.0, 100 * GB, 1.0, 1.0),)
IDEAL = (TierSpec("hb-dimm", 1.0, 200 * GB, 1.0, 2.0),)
TIERED = (
    TierSpec("hb-dimm", 0.375, 200 * GB, 1.0, 2.0),
    TierSpec("cxl", 0.625, 100 * GB, 1.8, 1.0),
)

# --- serving tiers (deployment analogue) ------------------------------------
# The relative figures (capacity 0.30 / 0.70, far latency 6.0x, cost 8.0 /
# 1.0) are the reference's virtual-time model, kept as they are so that the
# fleet's books (the router's far-latency pricing, the planner's split)
# match the reference's; they are not a measurement of this card. Only the
# bandwidths are the card's, and the planner does not read them.
SERVING_TIERED = (
    TierSpec("hbm", 0.30, HBM_BW, 1.0, 8.0),
    TierSpec("host-dram", 0.70, HOST_LINK_BW, 6.0, 1.0),
)

# utilization knee: production workloads can't push DDR past ~60-70% without
# the latency blow-up the paper describes (Fig. 4); microbenchmarks can.
BW_KNEE = 0.68
