"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): what every roofline and utilization
share of the benchmark is taken against."""

BF16_FLOPS = 989e12        # dense bf16 tensor-core FLOP/s
FP32_FLOPS = 67e12         # float32 FLOP/s outside the tensor cores
HBM_BYTES_S = 3.35e12      # HBM3 bytes/s
