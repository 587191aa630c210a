"""Mamba2 chunked SSD scan (CUDA kernel + plain version)."""
from repro_torch.kernels.ssd.ops import ssd, ssd_chunked

__all__ = ["ssd", "ssd_chunked"]
