"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity), which assume the card's full power limit of
700 W; every run prints the card's own limit beside its numbers."""
HBM_BYTES_S = 3.35e12
F32_FLOP_S = 67e12          # float32 outside the tensor cores
TF32_FLOP_S = 495e12        # tensor cores, TF32
BF16_FLOP_S = 989e12        # tensor cores, bf16
POWER_LIMIT_W = 700.0
