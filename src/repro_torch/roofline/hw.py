"""Hardware constants for the roofline model: one NVIDIA H100 SXM 80GB,
from NVIDIA's data sheet. Each is a data-sheet peak, not a measurement.

The collective term divides by NVLink 4's rate, which holds only inside
one 8-GPU node. A mesh wider than that (the dry-run's 256 and 512 ranks)
is bounded by the network between nodes, which no number here measures,
so its collective term is a lower bound.
"""

PEAK_FLOPS_BF16 = 989e12     # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12             # bytes/s, HBM3
NVLINK_BW = 450e9            # bytes/s per direction per GPU, NVLink 4

H100_HBM_BYTES = 80e9        # 80 GB of HBM3, capacity check
