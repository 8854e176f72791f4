"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): FP64 on the tensor cores and HBM3
bandwidth. A card set to a lower power limit runs below them; the
harness prints the limit beside every share of a peak."""

PEAK_FLOPS = {"float64": 67e12}
PEAK_BYTES_PER_S = 3.35e12
