"""Grouped expert MLP of the MoE FFN (CUDA kernels + plain versions)."""
from repro_torch.kernels.moe_gmm.ops import (gmm_down, gmm_down_ref,
                                             gmm_gated, gmm_gated_ref,
                                             grouped_mlp, grouped_mlp_ref)

__all__ = ["gmm_down", "gmm_down_ref", "gmm_gated", "gmm_gated_ref",
           "grouped_mlp", "grouped_mlp_ref"]
