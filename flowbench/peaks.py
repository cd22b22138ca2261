"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
at the 700 W limit): the yardstick of every share of a peak."""

# FLOP/s of the policy's products: bf16 on the tensor cores; fp32 with TF32
# off runs outside them
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
