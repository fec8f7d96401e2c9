"""Roofline terms from a dry-run cell (port of ``repro/roofline/report.py``
over the H100 constants of ``roofline/hw.py``).

All inputs are per device, so the terms are simply value / unit-rate.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, Optional

from repro_torch.roofline import hw


@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_per_device: float
    hlo_bytes_per_device: float
    collective_bytes_per_device: float
    model_flops_total: float            # 6*N*D (dense) / 6*N_active*D (MoE)
    argument_bytes_per_device: float = 0.0
    temp_bytes_per_device: float = 0.0
    collective_breakdown: Optional[Dict[str, float]] = None

    # ---- the three terms (seconds) ------------------------------------
    @property
    def t_compute(self) -> float:
        return self.hlo_flops_per_device / hw.PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes_per_device / hw.HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_device / hw.NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / total counted FLOPs — remat/redundancy waste."""
        total = self.hlo_flops_per_device * self.chips
        return self.model_flops_total / max(total, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time / achievable step time: how close the
        step is to the compute roofline if perfectly overlapped."""
        t_useful = (self.model_flops_total / self.chips) / hw.PEAK_FLOPS_BF16
        return t_useful / max(self.bound_time, 1e-12)

    def fits_hbm(self) -> bool:
        resident = self.argument_bytes_per_device + self.temp_bytes_per_device
        return resident <= hw.H100_HBM_BYTES

    def to_dict(self) -> Dict:
        d = asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, dominant=self.dominant,
                 useful_flops_ratio=self.useful_flops_ratio,
                 roofline_fraction=self.roofline_fraction,
                 fits_hbm=self.fits_hbm())
        return d


def format_row(r: RooflineTerms) -> str:
    return (f"| {r.arch} | {r.shape} | {r.mesh} | "
            f"{r.t_compute*1e3:.2f} | {r.t_memory*1e3:.2f} | "
            f"{r.t_collective*1e3:.2f} | {r.dominant} | "
            f"{r.useful_flops_ratio:.2f} | {r.roofline_fraction:.3f} |")


HEADER = ("| arch | shape | mesh | t_comp (ms) | t_mem (ms) | t_coll (ms) "
          "| dominant | useful/HLO | roofline frac |\n"
          "|---|---|---|---|---|---|---|---|---|")
