"""Published peaks of one NVIDIA H100 80GB HBM3 (SXM, 700 W; NVIDIA's data
sheet, dense rates), a frozen copy of ``repro_torch.core.hw``'s figures."""

PEAK_FLOPS_BF16 = 989e12  # FLOP/s on the tensor cores
PEAK_FLOPS_TF32 = 495e12  # FLOP/s on the tensor cores
PEAK_FLOPS_FP32 = 67e12  # FLOP/s on the CUDA cores
HBM_BW = 3.35e12  # B/s
