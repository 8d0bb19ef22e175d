"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W power limit)."""

TF32_FLOPS = 495e12  # TF32 tensor cores
HBM_BYTES_PER_S = 3.35e12
