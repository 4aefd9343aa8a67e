"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data
sheet, dense rates): float32 outside the tensor cores and HBM bandwidth.
The sweep runs float32 with TF32 off, so the float32 rate is its peak."""

FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
