"""Hardware catalog (the port's copy of ``repro.core.hardware``): the
paper's Table 1 edge platforms + hypothetical variants + the reference's
TPU v5e target.

PIM modeling (paper §3.2 / Table 1): the BF16 TFLOPS of PIM systems includes
SoC + PIM. Memory-bound GEMV-class operators (arithmetic intensity below the
PIM cutoff) execute in-memory at the PIM bank bandwidth with the PIM share of
compute; everything else runs on the SoC at the external interface bandwidth.
External BW for LPDDR6X host interface is assumed 2x LPDDR5X (546 GB/s) —
an assumption recorded here because the paper does not state it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional


@dataclass(frozen=True)
class Hardware:
    name: str
    mem_bw_gbs: float            # external memory bandwidth, GB/s
    bf16_tflops: float           # SoC peak BF16
    # efficiency knobs (calibrated against the paper's measured ratios)
    gemm_eff: float = 0.40       # achievable fraction of peak for big GEMMs
    gemv_bw_eff: float = 0.70    # achievable fraction of DRAM BW for GEMV
    # PIM extension
    pim: bool = False
    pim_bw_gbs: float = 0.0      # in-memory bank bandwidth
    pim_tflops: float = 0.0      # PIM share of compute (excl. SoC)
    pim_intensity_cutoff: float = 4.0   # FLOP/byte below which ops go to PIM
    # collective fabric (multi-chip parts)
    chips: int = 1
    ici_gbs: float = 0.0         # per-link interconnect bandwidth
    hbm_gb: float = 0.0

    @property
    def total_tflops(self) -> float:
        return self.bf16_tflops + self.pim_tflops

    @property
    def ridge_flops_per_byte(self) -> float:
        return (self.bf16_tflops * 1e12) / (self.mem_bw_gbs * 1e9)


# ----- Table 1 (verbatim specs) --------------------------------------------

ORIN = Hardware("jetson-orin", mem_bw_gbs=203, bf16_tflops=100, hbm_gb=64)
THOR = Hardware("jetson-thor", mem_bw_gbs=273, bf16_tflops=500, hbm_gb=128)

ORIN_LPDDR5X = Hardware("orin+lpddr5x", mem_bw_gbs=273, bf16_tflops=100, hbm_gb=64)
ORIN_GDDR7 = Hardware("orin+gddr7", mem_bw_gbs=1000, bf16_tflops=100, hbm_gb=64)
ORIN_PIM = Hardware("orin+pim", mem_bw_gbs=546, bf16_tflops=100,
                    pim=True, pim_bw_gbs=2180, pim_tflops=1074 - 100, hbm_gb=64)
THOR_GDDR7 = Hardware("thor+gddr7", mem_bw_gbs=1000, bf16_tflops=500, hbm_gb=128)
THOR_PIM = Hardware("thor+pim", mem_bw_gbs=546, bf16_tflops=500,
                    pim=True, pim_bw_gbs=2180, pim_tflops=3993 - 500, hbm_gb=128)

# ----- TPU target (roofline constants used by repro.roofline) ---------------

TPU_V5E = Hardware("tpu-v5e", mem_bw_gbs=819, bf16_tflops=197,
                   gemm_eff=0.55, gemv_bw_eff=0.80,
                   chips=256, ici_gbs=50, hbm_gb=16)

# ----- the port's card (data-sheet constants, not measurements) ----------
# NVIDIA H100 SXM5 80GB: 3.35 TB/s HBM3, 989 TFLOP/s dense bf16 on the
# tensor cores, NVLink 4 at 900 GB/s both ways (450 GB/s each way). Kept
# out of CATALOG and TABLE1, which stay the reference's; chip_smoke.py
# and roofline.report price the card with it.

H100_SXM = Hardware("h100-sxm", mem_bw_gbs=3350, bf16_tflops=989,
                    chips=1, ici_gbs=450, hbm_gb=80)

CATALOG: Dict[str, Hardware] = {h.name: h for h in [
    ORIN, THOR, ORIN_LPDDR5X, ORIN_GDDR7, ORIN_PIM, THOR_GDDR7, THOR_PIM,
    TPU_V5E,
]}

TABLE1 = ["jetson-orin", "jetson-thor", "orin+lpddr5x", "orin+gddr7",
          "orin+pim", "thor+gddr7", "thor+pim"]


def get_hardware(name: str) -> Hardware:
    return CATALOG[name]
